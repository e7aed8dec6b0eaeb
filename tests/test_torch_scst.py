"""SCST in the port (`Trainer.train(sc_flag=True)`, `losses/rewards.py`,
`criterion.reward_loss`) against the JAX package on the CPU, at tiny
widths (denseatt: V 20, widths 24, 6 att slots, seq_length 5, batch 3;
the transformer captioner: 2 layers, d 32, 4 heads).

The two frameworks draw other samples, so everything is held on given
sequences: `reward_loss` (the first-EOS mask shift, a 1-D advantage) and
the self-critical reward within 1e-5; the teacher-forcing recompute's
loss (rtol 1e-5) and gradient (atol 1e-5, rtol 1e-4) on bridged
parameters against `jax.value_and_grad`, on each denseatt attention route;
the recompute against the port's own step-by-step decode under grad; one
whole SCST trainer step (both models' `sample` patched to return the same
given sequences; Adam eps 1e-6 as in the XE parity tests) within 1e-5.

`STEP_FUSION` (the fused att -> lstm -> att decode step, no backward):
the recompute runs under grad, so it must take the unfused route; the
decodes under no_grad keep the fused one, and an SCST step with the flag
equals the step without it. Real sampling: SCST trains both families and
the joint step with the NMT; with the empty df table every reward, loss
and gradient is 0.
"""

import numpy as np
import pytest
import torch

from unpaired_image_captioning_tpu_torch import bridge
from unpaired_image_captioning_tpu_torch import models as tmodels
from unpaired_image_captioning_tpu_torch.config import Config as TConfig
from unpaired_image_captioning_tpu_torch.kernels import (
    additive_attention as aak)
from unpaired_image_captioning_tpu_torch.losses import criterion as tcrit
from unpaired_image_captioning_tpu_torch.losses import rewards as trew
from unpaired_image_captioning_tpu_torch.models import att as tatt
from unpaired_image_captioning_tpu_torch.models.base import Features
from unpaired_image_captioning_tpu_torch.ops import cider as tc
from unpaired_image_captioning_tpu_torch.scripts.prepro_ngrams import (
    compute_df)
from unpaired_image_captioning_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)
B, N, T, V, R = 3, 6, 5, 20, 4
TOL = 1e-5
BASE = dict(vocab_size=V, fc_feat_size=16, att_feat_size=16, seq_length=T,
            batch_size=B, seq_per_img=1, i2t_train_flag=True,
            i2t_max_grad_norm=5.0, i2t_learning_rate=5e-4, seed=7,
            drop_prob_lm=0.0, i2t_optim_epsilon=1e-6)
FAMILIES = {
    "denseatt": dict(BASE, caption_model="denseatt", input_encoding_size=24,
                     rnn_size=24, num_layers=1, att_hid_size=24),
    "transformer": dict(BASE, caption_model="transformer",
                        input_encoding_size=32, rnn_size=32, num_layers=2,
                        num_heads=4, att_hid_size=32),
}
# the denseatt attention routes of the recompute
ROUTES = {"plain": {}, "SINGLE_KERNEL": {"SINGLE_KERNEL": True},
          "STEP_FUSION": {"STEP_FUSION": True}}


def _gts(seed=0):
    """Ground truths [B, R, T + 2] (0-padded) with one masked reference,
    and the df of a corpus that holds them (12 more images of 4)."""
    rs = np.random.RandomState(seed)
    rows = np.zeros(((B + 12) * R, T + 2), np.int64)
    for i in range(len(rows)):
        n = rs.randint(2, T + 3)
        rows[i, :n] = rs.randint(1, V + 1, n)
    start = np.arange(B + 12) * R + 1
    df, n_img = compute_df(rows, start, start + R - 1)
    mask = np.ones((B, R), np.float32)
    mask[1, 3] = 0.0
    return rows[:B * R].reshape(B, R, -1), mask, df, float(n_img)


def _seqs(gts, seed=1):
    """Given (gen, greedy) [B, T]: gen rows take words of their references,
    end at EOS at steps 4, 2 and never; greedy rows are other words."""
    rs = np.random.RandomState(seed)
    gen = np.zeros((B, T), np.int64)
    gen[0, :4] = gts[0, 0, :4]
    gen[1, :2] = gts[1, 2, 1:3]
    gen[2] = rs.randint(1, V + 1, T)
    gen[2, 1:3] = gts[2, 1, :2]
    gen[gen == 0] = 1
    gen[0, 4:] = 0
    gen[1, 2:] = 0
    greedy = rs.randint(1, V + 1, (B, T))
    greedy[0, 3:] = 0
    return gen, greedy


def _feats_np(seed=2):
    rs = np.random.RandomState(seed)
    att_masks = np.ones((B, N), np.float32)
    att_masks[1, 4:] = 0.0
    return {"fc_feats": rs.randn(B, 16).astype(np.float32),
            "att_feats": rs.randn(B, N, 16).astype(np.float32),
            "att_masks": att_masks}


def _jax_feats(f):
    import jax.numpy as jnp

    from unpaired_image_captioning_tpu.models.base import Features as JF

    return JF(fc_feats=jnp.asarray(f["fc_feats"]),
              att_feats=jnp.asarray(f["att_feats"]), attri_feats=None,
              att_masks=jnp.asarray(f["att_masks"]))


def _port_feats(f):
    return Features(fc_feats=torch.from_numpy(f["fc_feats"]),
                    att_feats=torch.from_numpy(f["att_feats"]),
                    attri_feats=None,
                    att_masks=torch.from_numpy(f["att_masks"]))


# ---------------------------------------------------------------------------
# reward_loss and the self-critical reward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("adv_dims", [1, 2], ids=["advantage_B",
                                                  "advantage_BT"])
def test_reward_loss_matches_jax(adv_dims):
    import jax.numpy as jnp

    from unpaired_image_captioning_tpu.losses import criterion as jcrit

    rs = np.random.RandomState(0)
    gen = rs.randint(1, V + 1, (4, T))
    gen[0, 2:] = 0          # first EOS at step 2: steps 0..2 count
    gen[1, 0:] = 0          # EOS at step 0: only step 0 counts
    gen[3, 4] = 0           # EOS at the last step
    lp = -rs.rand(4, T).astype(np.float32)
    adv = rs.randn(*((4,) if adv_dims == 1 else (4, T))).astype(np.float32)
    want = float(jcrit.reward_loss(jnp.asarray(lp), jnp.asarray(gen),
                                   jnp.asarray(adv)))
    got = tcrit.reward_loss(torch.from_numpy(lp), torch.from_numpy(gen),
                            torch.from_numpy(adv))
    np.testing.assert_allclose(float(got), want, rtol=TOL, atol=TOL)
    # the mask: (gen > 0) shifted right by one with a leading 1
    mask = np.concatenate([np.ones((4, 1)), (gen[:, :-1] > 0)], 1)
    assert mask.sum() == 3 + 1 + T + T
    a = adv[:, None] * np.ones((4, T)) if adv_dims == 1 else adv
    np.testing.assert_allclose(float(got), (-lp * a * mask).sum() / mask.sum(),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("weights", [(1.0, 0.0), (0.5, 2.0)],
                         ids=["cider", "cider_bleu"])
def test_self_critical_reward_matches_jax(weights):
    import jax
    import jax.numpy as jnp

    from unpaired_image_captioning_tpu.losses import rewards as jrew
    from unpaired_image_captioning_tpu.ops import cider as jc

    gts, mask, df, n_img = _gts()
    gen, greedy = _seqs(gts)
    kw = dict(cider_weight=weights[0], bleu_weight=weights[1])
    table = jc.build_df_table(df, n_img)
    adv_j, rs_j = jax.jit(lambda *a: jrew.get_self_critical_reward(
        *a, table, **kw))(jnp.asarray(gen), jnp.asarray(greedy),
                          jnp.asarray(gts), jnp.asarray(mask))
    adv_t, rs_t = trew.get_self_critical_reward(
        torch.from_numpy(gen), torch.from_numpy(greedy),
        torch.from_numpy(gts), torch.from_numpy(mask),
        tc.build_df_table(df, n_img, device="cpu"), **kw)
    assert adv_t.shape == (B, T) and adv_t.dtype == torch.float32
    np.testing.assert_allclose(adv_t.numpy(), np.asarray(adv_j), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(rs_t.numpy(), np.asarray(rs_j), rtol=TOL,
                               atol=TOL)
    assert (rs_t > 0).all() and (adv_t[:, 0] != 0).all()


# ---------------------------------------------------------------------------
# the recompute: its loss and gradient
# ---------------------------------------------------------------------------

def _models(family):
    import jax

    from unpaired_image_captioning_tpu import models as jmodels
    from unpaired_image_captioning_tpu.config import Config

    jm = jmodels.setup(Config(**FAMILIES[family]))
    params = jm.init_params(jax.random.PRNGKey(0))
    tm = tmodels.setup(TConfig(**FAMILIES[family]), device="cpu")
    tm.load_state_dict(bridge.params_from_jax(params))
    return jm, params, tm


def _adv():
    # advantages of both signs whose terms do not cancel in the loss (a
    # loss far below its terms would be all rounding)
    return np.array([1.0, -0.5, 2.0], np.float32)[:, None] * np.ones(
        (B, T), np.float32)


def _port_recompute(model, feats, gen, adv):
    seq_full = torch.cat([torch.zeros_like(gen[:, :1]), gen], 1)
    out = model.forward(feats, seq_full, training=False)
    lp = torch.gather(out, -1, gen[..., None])[..., 0]
    return tcrit.reward_loss(lp, gen, adv)


def _grads_close(names, got, want_tree):
    want = bridge.params_from_jax(want_tree)
    assert set(want) == set(names)
    for name, g in zip(names, got):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("family,route", [
    ("denseatt", "plain"), ("denseatt", "SINGLE_KERNEL"),
    ("denseatt", "STEP_FUSION"), ("transformer", "plain")])
def test_recompute_gradient_matches_jax(monkeypatch, family, route):
    """With STEP_FUSION set the recompute runs under grad: the gate must
    keep the fused step (which has no backward and raises) out of it."""
    import jax
    import jax.numpy as jnp

    from unpaired_image_captioning_tpu.losses import criterion as jcrit

    for flag, value in ROUTES[route].items():
        monkeypatch.setattr(tatt, flag, value)
    jm, params, tm = _models(family)
    gts, _, _, _ = _gts()
    gen, _ = _seqs(gts)
    f = _feats_np()
    adv = _adv()

    def loss_j(p):
        seq_full = jnp.concatenate([jnp.zeros((B, 1), jnp.int32),
                                    jnp.asarray(gen, jnp.int32)], 1)
        out = jm.forward(p, _jax_feats(f), seq_full, training=False)
        lp = jnp.take_along_axis(out, jnp.asarray(gen, jnp.int32)[..., None],
                                 axis=-1)[..., 0]
        return jcrit.reward_loss(lp, jnp.asarray(gen), jnp.asarray(adv))

    lj, gj = jax.jit(jax.value_and_grad(loss_j))(params)
    names, ps = zip(*tm.named_parameters())
    lt = _port_recompute(tm, _port_feats(f), torch.from_numpy(gen),
                         torch.from_numpy(adv))
    # the kernel route drops the alpha_net bias: no gradient reaches it
    gt = [torch.zeros_like(p) if g is None else g for p, g in zip(
        ps, torch.autograd.grad(lt, ps, allow_unused=True))]
    np.testing.assert_allclose(lt.item(), float(lj), rtol=TOL)
    _grads_close(names, gt, gj)
    assert max(float(g.abs().max()) for g in gt) > 0


def test_recompute_is_the_stepwise_decode_under_grad():
    """The teacher-forcing recompute and a step-by-step replay of the
    decode under grad are one function of the parameters (both without
    dropout): the same loss and gradient."""
    _, _, tm = _models("denseatt")
    gts, _, _, _ = _gts()
    gen = torch.from_numpy(_seqs(gts)[0])
    feats = _port_feats(_feats_np())
    adv = torch.from_numpy(_adv())
    names, ps = zip(*tm.named_parameters())
    la = _port_recompute(tm, feats, gen, adv)
    ga = torch.autograd.grad(la, ps)
    ctx, state = tm.make_decoder(feats, training=False)
    it = torch.zeros((B,), dtype=torch.int64)
    lps = []
    for t in range(T):
        logprobs, state = tm.step(ctx, state, it, training=False)
        lps.append(torch.gather(logprobs, 1, gen[:, t:t + 1])[:, 0])
        it = gen[:, t]
    lb = tcrit.reward_loss(torch.stack(lps, 1), gen, adv)
    gb = torch.autograd.grad(lb, ps)
    np.testing.assert_allclose(la.item(), lb.item(), rtol=1e-6)
    for name, a, b in zip(names, ga, gb):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5,
                                   rtol=1e-4, err_msg=name)


def test_step_fusion_keeps_decodes_and_leaves_the_recompute(monkeypatch):
    """Under no_grad (the decodes) STEP_FUSION sends every decode step to
    the fused call; under grad (the recompute) none."""
    monkeypatch.setattr(tatt, "STEP_FUSION", True)
    calls = []

    def spy(*a, _fn=aak.fused_att_lstm_att, **kw):
        calls.append(torch.is_grad_enabled())
        return _fn(*a, **kw)

    monkeypatch.setattr(aak, "fused_att_lstm_att", spy)
    _, _, tm = _models("denseatt")
    feats = _port_feats(_feats_np())
    seq, _ = tm.sample(feats, greedy=True)
    steps = len(calls)
    assert steps > 0 and not any(calls)
    loss = _port_recompute(tm, feats, seq, torch.from_numpy(_adv()))
    loss.backward()
    assert len(calls) == steps


# ---------------------------------------------------------------------------
# Trainer.train(sc_flag=True)
# ---------------------------------------------------------------------------

def _scst_batch():
    gts, mask, df, n_img = _gts()
    return dict(_feats_np(), gts=gts, gts_masks=mask), df, n_img


@pytest.mark.parametrize("family", list(FAMILIES))
def test_scst_steps_match_jax_trainer(tmp_path, monkeypatch, family):
    import jax
    import jax.numpy as jnp

    from unpaired_image_captioning_tpu.config import Config
    from unpaired_image_captioning_tpu.models import transformer as jtr
    from unpaired_image_captioning_tpu.ops import cider as jc
    from unpaired_image_captioning_tpu.train.trainer import Trainer as JT

    monkeypatch.setattr(jtr, "DROPOUT", 0.0)
    batch, df, n_img = _scst_batch()
    gen, greedy = _seqs(batch["gts"])
    kw = FAMILIES[family]
    # dtype f32 on both sides: the trainers otherwise round the features
    # to bf16 (both defaults are "bfloat16")
    jt = JT(Config(**kw, dtype="float32", checkpoint_path=str(tmp_path)),
            df_table=jc.build_df_table(df, n_img))
    pt = Trainer(TConfig(**kw, dtype="float32"), device="cpu",
                 df_table=tc.build_df_table(df, n_img, device="cpu"))
    pt.i2t_model.load_state_dict(bridge.params_from_jax(jt.i2t_params))

    def jax_sample(self, params, feats, rng, *, greedy=True, **_):
        return jnp.asarray(_pick(greedy), jnp.int32), None

    def _pick(is_greedy):
        return greedy if is_greedy else gen

    monkeypatch.setattr(type(jt.i2t_model), "sample", jax_sample)
    monkeypatch.setattr(pt.i2t_model, "sample",
                        lambda feats, *, greedy=True, **_: (
                            torch.from_numpy(_pick(greedy)), None))
    for _ in range(2):
        jm = jt.train(batch, sc_flag=True)
        tm = pt.train(batch, sc_flag=True)
        for key in ("total_loss", "i2t_loss", "avg_reward"):
            np.testing.assert_allclose(tm[key], jm[key], rtol=TOL, atol=TOL,
                                       err_msg=key)
    assert tm["avg_reward"] > 0 and tm["i2t_loss"] != 0
    got = bridge.params_to_numpy(pt.i2t_model)
    flat_j = jax.tree_util.tree_leaves_with_path(jt.i2t_params)
    assert len(flat_j) == len(list(pt.i2t_model.parameters()))
    for path, want in flat_j:
        node = got
        for p in path:
            node = node[getattr(p, "key", getattr(p, "idx", None))]
        np.testing.assert_allclose(node, np.asarray(want), rtol=TOL, atol=TOL,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_scst_trains_with_real_samples(family):
    """Sampled and greedy decodes from the model itself: finite losses, a
    reward above 0, every parameter of the captioner moved but none with
    the empty table, whose rewards, loss and gradient are all 0."""
    batch, df, n_img = _scst_batch()
    kw = dict(FAMILIES[family], i2t_optim="sgd", i2t_learning_rate=1.0)
    for table in ("prepro", "empty"):
        tr = Trainer(TConfig(**kw, dtype="float32"), device="cpu", df_table=(
            tc.build_df_table(df, n_img, device="cpu")
            if table == "prepro" else None))
        before = [p.detach().clone() for p in tr.i2t_model.parameters()]
        outs = [tr.train(batch, sc_flag=True) for _ in range(3)]
        assert all(np.isfinite(o["total_loss"]) for o in outs)
        moved = [not torch.equal(p, b) for p, b in
                 zip(tr.i2t_model.parameters(), before)]
        if table == "empty":
            assert all(o["avg_reward"] == o["i2t_loss"] == 0 for o in outs)
            assert not any(moved)
        else:
            assert max(o["avg_reward"] for o in outs) > 0
            assert sum(moved) > len(moved) // 2


def test_scst_step_with_step_fusion_equals_unfused(monkeypatch):
    """Real samples: with STEP_FUSION the decodes take the fused step and
    the recompute the unfused one; the step's tokens, loss, reward and
    updated parameters equal those of the step without the flag."""
    batch, df, n_img = _scst_batch()
    calls = []

    def spy(*a, _fn=aak.fused_att_lstm_att, **kw):
        calls.append(1)
        return _fn(*a, **kw)

    monkeypatch.setattr(aak, "fused_att_lstm_att", spy)
    runs = {}
    for fused in (False, True):
        monkeypatch.setattr(tatt, "STEP_FUSION", fused)
        tr = Trainer(TConfig(**FAMILIES["denseatt"]), device="cpu",
                     df_table=tc.build_df_table(df, n_img, device="cpu"))
        out = tr.train(batch, sc_flag=True)
        runs[fused] = (out, [p.detach().clone()
                             for p in tr.i2t_model.parameters()])
    assert calls                        # the decodes took the fused step
    (o0, p0), (o1, p1) = runs[False], runs[True]
    for key in ("total_loss", "i2t_loss", "avg_reward"):
        np.testing.assert_allclose(o1[key], o0[key], rtol=TOL, atol=TOL)
    for a, b in zip(p1, p0):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=TOL, atol=TOL)


def test_joint_scst_and_nmt_step():
    """SCST of the denseatt captioner in the joint step with the BiLSTM
    NMT and Weight_Trans: one backward over the sum, every term reported
    and finite."""
    batch, df, n_img = _scst_batch()
    rs = np.random.RandomState(3)
    src = rs.randint(4, 31, (B, 6))
    src[1, 4:] = 0
    tgt = np.zeros((B, 7), np.int64)
    tgt[:, 0], tgt[:, 1:5], tgt[:, 5] = 2, rs.randint(4, 29, (B, 4)), 3
    batch["nmt"] = {"src": src, "tgt": tgt, "lengths": np.array([6, 4, 6])}
    cfg = TConfig(**dict(FAMILIES["denseatt"], nmt_src_vocab_size=31,
                         nmt_tgt_vocab_size=29, word_vec_size=24, layers=1,
                         brnn=True, dropout=0.0, nmt_train_flag=True))
    tr = Trainer(cfg, device="cpu", joint_vocab=([1, 3, 4], [5, 3, 30]),
                 df_table=tc.build_df_table(df, n_img, device="cpu"))
    out = tr.train(batch, sc_flag=True)
    want = {"i2t_loss", "avg_reward", "nmt_loss", "nmt_ppl", "nmt_acc",
            "nmt_words", "wemb_loss", "total_loss"}
    assert want <= set(out)
    assert all(np.isfinite(out[k]) for k in want)
    assert out["nmt_words"] == 5 * B
    np.testing.assert_allclose(
        out["total_loss"], out["i2t_loss"] + out["nmt_loss"]
        + out["wemb_loss"], rtol=1e-6)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("family", list(FAMILIES))
def test_cuda_rl_loss_and_gradient_match_cpu(cuda_dev, family):
    """`Trainer._rl_loss` and its gradient on given sequences, through the
    kernels on the card and the plain versions on the CPU: the loss within
    1e-4 relative, each gradient within 1e-4 * max(1, max|g|)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    batch, df, n_img = _scst_batch()
    gen, greedy = _seqs(batch["gts"])
    got = {}
    for dev in (cuda_dev, torch.device("cpu")):
        tr = Trainer(TConfig(**FAMILIES[family]), device=dev,
                     df_table=tc.build_df_table(df, n_img, device=dev))
        up = tr._batch(batch)
        feats = Features(up["fc_feats"], up["att_feats"], None,
                         up["att_masks"])
        loss, rs = tr._rl_loss(feats, *(torch.from_numpy(s).to(dev)
                                        for s in (gen, greedy)),
                               up["gts"], up["gts_masks"])
        loss.backward()
        got[dev.type] = (float(loss), rs.cpu(), [
            p.grad.cpu() for p in tr.i2t_model.parameters()])
    (lg, rg, gg), (lc, rc, gc) = got["cuda"], got["cpu"]
    assert abs(lg - lc) <= 1e-4 * abs(lc)
    torch.testing.assert_close(rg, rc, rtol=1e-5, atol=1e-5)
    for a, b in zip(gg, gc):
        assert (a - b).abs().max() <= 1e-4 * max(1.0, float(b.abs().max()))


@pytest.mark.cuda
def test_cuda_scst_step_with_step_fusion(cuda_dev, monkeypatch):
    """An SCST step on the card with STEP_FUSION: the decodes launch the
    fused step kernel, the recompute does not, and the step is finite."""
    batch, df, n_img = _scst_batch()
    monkeypatch.setattr(tatt, "STEP_FUSION", True)
    tr = Trainer(TConfig(**FAMILIES["denseatt"]), device=cuda_dev,
                 df_table=tc.build_df_table(df, n_img, device=cuda_dev))
    before = aak.step_launches
    out = tr.train(batch, sc_flag=True)
    assert aak.step_launches > before
    assert np.isfinite(out["total_loss"])
