"""PyTorch port, the transformer captioner: the primitives, teacher-forced
logprobs and the caption beam against the JAX package on the same
parameters (carried over by bridge.params_from_jax) and the same numpy
features, and the reference's own self-check that the incremental decode
(through the decoder-step kernel's plain version) equals the parallel
forward, on both decode routes.

Tolerances: logprobs atol 1e-5 (f32); beam tokens identical and scores /
per-token logprobs atol 1e-4 (sums over up to 7 steps)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unpaired_image_captioning_tpu import models as jmodels
from unpaired_image_captioning_tpu.config import Config
from unpaired_image_captioning_tpu.models import transformer as jtr
from unpaired_image_captioning_tpu.models.base import Features as JFeatures
from unpaired_image_captioning_tpu_torch import bridge
from unpaired_image_captioning_tpu_torch import models as tmodels
from unpaired_image_captioning_tpu_torch.kernels import layer_train as ltk
from unpaired_image_captioning_tpu_torch.models import transformer as ttr
from unpaired_image_captioning_tpu_torch.models.base import Features

torch.set_num_threads(1)

V, T, B, N = 21, 7, 3, 5
CFG = Config(caption_model="transformer", vocab_size=V, rnn_size=48,
             num_layers=2, input_encoding_size=32, att_hid_size=16,
             fc_feat_size=10, att_feat_size=12, seq_length=T,
             drop_prob_lm=0.0, num_heads=4)


@pytest.fixture(scope="module")
def pair():
    jm = jmodels.setup(CFG)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tm = tmodels.setup(CFG, device="cpu")
    assert isinstance(tm, ttr.TransformerModel)
    tm.load_state_dict(bridge.params_from_jax(jp))
    tm.eval()
    rs = np.random.RandomState(0)
    fc = rs.randn(B, CFG.fc_feat_size).astype(np.float32)
    att = rs.randn(B, N, CFG.att_feat_size).astype(np.float32)
    masks = np.ones((B, N), np.float32)
    masks[0, 3:] = 0.0                      # padded attention slots
    jf = JFeatures(fc_feats=jnp.asarray(fc), att_feats=jnp.asarray(att),
                   att_masks=jnp.asarray(masks))
    tf = Features(fc_feats=torch.from_numpy(fc),
                  att_feats=torch.from_numpy(att),
                  att_masks=torch.from_numpy(masks))
    return jm, jp, tm, jf, tf


def test_primitives_match_jax(pair):
    _, jp, tm, _, _ = pair
    np.testing.assert_allclose(ttr.positional_encoding(9, 32).numpy(),
                               np.asarray(jtr.positional_encoding(9, 32)),
                               atol=1e-6)
    rs = np.random.RandomState(1)
    x = (3 * rs.randn(4, 2, 32) + 1).astype(np.float32)
    lp = jp["dec"][0]
    np.testing.assert_allclose(
        ttr.layer_norm(tm.dec[0]["n1"], torch.from_numpy(x)).detach().numpy(),
        np.asarray(jtr.layer_norm(lp["n1"], jnp.asarray(x))), atol=1e-5)
    # cross-attention of [B*K, 1, d] beam queries over unexpanded memory
    y = rs.randn(6, 1, 32).astype(np.float32)
    ck, cv = (rs.randn(2, 5, 32).astype(np.float32) for _ in range(2))
    m = np.ones((2, 1, 5), bool)
    m[1, 0, 2:] = False
    with torch.no_grad():
        got = ttr.cross_attend_shared(tm.dec[0]["src"], torch.from_numpy(y),
                                      torch.from_numpy(ck),
                                      torch.from_numpy(cv),
                                      torch.from_numpy(m), 4)
    want = jtr.cross_attend_shared(lp["src"], jnp.asarray(y), jnp.asarray(ck),
                                   jnp.asarray(cv), jnp.asarray(m), 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_forward_logprobs_match_jax(pair):
    jm, jp, tm, jf, tf = pair
    seq = np.random.RandomState(1).randint(
        0, V + 1, (B, T + 2)).astype(np.int32)
    seq[:, 0] = 0
    seq[1, 5:] = 0                          # padded target positions
    jl = jm.forward(jp, jf, jnp.asarray(seq), training=False)
    with torch.no_grad():
        tl = tm.forward(tf, torch.from_numpy(seq).long())
    assert tl.shape == (B, T + 1, V + 1)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)


@pytest.mark.parametrize("stack", [True, False], ids=["stack", "per-layer"])
def test_incremental_step_matches_parallel(pair, monkeypatch, stack):
    """Teacher forcing through `step` (the fixed K/V cache, one decode
    kernel call per step or per layer) equals the parallel forward at every
    step (reference TransformerModel.py:521-523)."""
    _, _, tm, _, tf = pair
    monkeypatch.setattr(ttr, "STACK_KERNEL", stack)
    seq = np.random.RandomState(2).randint(1, V + 1, (B, T)).astype(np.int64)
    full = torch.from_numpy(np.concatenate([np.zeros((B, 1), np.int64), seq],
                                           1))
    with torch.no_grad():
        par = tm.forward(tf, full)                        # [B, T, V+1]
        ctx, state = tm.make_decoder(tf)
        assert ("wstack" in ctx) == stack
        it = full[:, 0]
        for t in range(T):
            lp, state = tm.step(ctx, state, it)
            np.testing.assert_allclose(lp.numpy(), par[:, t].numpy(),
                                       atol=1e-5, err_msg=f"step {t}")
            it = full[:, t + 1]
        assert state["t"].tolist() == [T] * B


def test_step_per_row_positions(pair):
    """Rows at different positions in one step (t = [2, 1]) equal each row
    stepped on its own."""
    _, _, tm, _, tf = pair
    f2 = Features(*(x[:2] for x in (tf.fc_feats, tf.att_feats)), None,
                  tf.att_masks[:2])
    with torch.no_grad():
        ctx, state = tm.make_decoder(f2)

        def row(tree, i):
            out = {}
            for k, v in tree.items():
                if k in ("wstack", "pe"):                  # not per image
                    out[k] = v
                elif k in ("cross_k", "cross_v"):          # [L, B, S, d]
                    out[k] = v[:, i:i + 1].clone()
                else:
                    out[k] = v[i:i + 1].clone()
            return out

        c0, s0 = row(ctx, 0), row(state, 0)
        for tok in (3, 5):
            _, s0 = tm.step(c0, s0, torch.tensor([tok]))
        c1, s1 = row(ctx, 1), row(state, 1)
        _, s1 = tm.step(c1, s1, torch.tensor([7]))
        both = {k: torch.cat([s0[k], s1[k]]) for k in s0}
        assert both["t"].tolist() == [2, 1]
        lp, _ = tm.step(ctx, both, torch.tensor([9, 11]))
        lp0, _ = tm.step(c0, s0, torch.tensor([9]))
        lp1, _ = tm.step(c1, s1, torch.tensor([11]))
    np.testing.assert_allclose(lp[0].numpy(), lp0[0].numpy(), atol=1e-5)
    np.testing.assert_allclose(lp[1].numpy(), lp1[0].numpy(), atol=1e-5)


@pytest.mark.parametrize("beam", [3, 5])
def test_sample_beam_matches_jax(pair, beam):
    jm, jp, tm, jf, tf = pair
    jr = jax.jit(lambda p, f: jm.sample_beam(p, f, beam_size=beam))(jp, jf)
    with torch.no_grad():
        tr = tm.sample_beam(tf, beam_size=beam)
    np.testing.assert_array_equal(tr.seq.numpy(), np.asarray(jr.seq))
    np.testing.assert_allclose(tr.scores.numpy(), np.asarray(jr.scores),
                               atol=1e-4)
    np.testing.assert_allclose(tr.logps.numpy(), np.asarray(jr.logps),
                               atol=1e-4)


def test_beam_keeps_cross_memory_unexpanded(pair):
    """The cross K/V, mask and packed weights stay [B, ...] in the beam;
    the state's caches are expanded to the B*K rows."""
    _, _, tm, _, tf = pair
    from unpaired_image_captioning_tpu_torch.ops import beam_search as bs

    seen = {}
    orig = tm.step

    def spy(ctx, state, it):
        seen.setdefault("ck", ctx["cross_k"].shape)
        seen.setdefault("k_all", state["k_all"].shape)
        return orig(ctx, state, it)

    ctx, state0 = tm.make_decoder(tf)
    with torch.no_grad():
        bs.beam_search(spy, ctx, state0, beam_size=3, seq_length=T,
                       ctx_no_expand=tm.beam_ctx_no_expand)
    d, n_l = CFG.input_encoding_size, CFG.num_layers
    assert seen["ck"] == (n_l, B, N, d)
    assert seen["k_all"] == (B * 3, n_l, T, d)


def test_unported_options_raise(pair, monkeypatch):
    _, _, tm, _, tf = pair
    # use_bn builds since A10 (its parity is tests/test_torch_batchnorm.py)
    for use_bn in (1, 2):
        bn = tmodels.setup(Config(**{**vars(CFG), "use_bn": use_bn}),
                           device="cpu")
        assert hasattr(bn, "bn0") and hasattr(bn, "bn1") == (use_bn == 2)
    # the whole-layer training route: one encoder-layer call per layer
    monkeypatch.setattr(ttr, "TRAIN_LAYER_KERNEL", True)
    calls = []
    fwd = ltk.enc_layer_fwd
    monkeypatch.setattr(ltk, "enc_layer_fwd",
                        lambda *a, **kw: calls.append(1) or fwd(*a, **kw))
    out = tm.forward(tf, torch.zeros((B, 3), dtype=torch.long), training=True)
    assert len(calls) == CFG.num_layers
    assert torch.isfinite(out).all()


def test_init_params_shapes_match_jax(pair):
    _, jp, _, _, _ = pair
    fresh = tmodels.setup(CFG, device="cpu").init_params(torch.Generator().manual_seed(0))
    shapes_t = jax.tree_util.tree_map(np.shape, bridge.params_to_numpy(fresh))
    assert shapes_t == jax.tree_util.tree_map(np.shape, jp)
    emb = fresh.tgt_embed.detach()
    assert abs(float(emb.std()) - CFG.input_encoding_size ** -0.5) < 0.02
    assert float(fresh.dec[0]["n1"].scale.detach().min()) == 1.0
