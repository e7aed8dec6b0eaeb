"""PyTorch port, the transformer NMT: encoder, teacher-forced decoder
outputs and generator logits (also with shared decoder embeddings) under
ragged source lengths, and the beam translate through the decoder-step
kernel's plain version with the lazy K/V cache, against the JAX package on
the same parameters and inputs; `make_nmt_model`; and `onmt_beam_search`'s
lazy caches against the JAX beam on a scripted step.

Tolerances: encoder / decoder outputs and logits atol 1e-5 (f32); beam
tokens and UNK-replacement aux identical, scores atol 1e-5
(tests/test_nmt_transformer.py's own)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unpaired_image_captioning_tpu import constants as C
from unpaired_image_captioning_tpu.models import nmt_transformer as jnt
from unpaired_image_captioning_tpu.ops import beam_search as jbs
from unpaired_image_captioning_tpu_torch import bridge
from unpaired_image_captioning_tpu_torch.models import nmt_transformer as tnt
from unpaired_image_captioning_tpu_torch.ops import beam_search as tbs

torch.set_num_threads(1)

SRC_V, TGT_V, B, S, T = 31, 29, 4, 7, 6
KW = dict(src_vocab_size=SRC_V, tgt_vocab_size=TGT_V, d_model=32, d_ff=48,
          num_layers=2, num_heads=4, max_decode_len=8)


def _pair(**kw):
    jm = jnt.TransformerNMTModel(**{**KW, **kw})
    jp = jm.init_params(jax.random.PRNGKey(1))
    tm = tnt.TransformerNMTModel(**{**KW, **kw})
    tm.load_state_dict(bridge.params_from_jax(jp))
    tm.eval()
    return jm, jp, tm


@pytest.fixture(scope="module")
def pair():
    return _pair()


@pytest.fixture(scope="module")
def batch():
    rs = np.random.RandomState(2)
    lengths = np.array([S, S - 2, S - 1, 3], np.int32)      # ragged
    src = rs.randint(4, SRC_V, (B, S)).astype(np.int32)
    src[np.arange(S)[None, :] >= lengths[:, None]] = C.PAD
    tgt = rs.randint(4, TGT_V, (B, T)).astype(np.int32)
    tgt[:, 0] = C.BOS
    tgt[:, -1] = C.EOS
    tgt[3, 4:] = C.PAD
    return src, lengths, tgt


def _t(a):
    return torch.from_numpy(np.asarray(a)).long()


def test_encode_matches_jax(pair, batch):
    jm, jp, tm = pair
    src, lengths, _ = batch
    jmem, jmask = jm.encode(jp, jnp.asarray(src), jnp.asarray(lengths))
    with torch.no_grad():
        tmem, tmask = tm.encode(_t(src), _t(lengths))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    np.testing.assert_allclose(tmem.numpy(), np.asarray(jmem), atol=1e-5)


@pytest.mark.parametrize("share", [False, True], ids=["generator", "shared"])
def test_forward_and_logits_match_jax(batch, share):
    jm, jp, tm = _pair(share_decoder_embeddings=share)
    src, lengths, tgt = batch
    assert ("w" in jp["generator"]) != share
    jout, _ = jm.forward(jp, jnp.asarray(src), jnp.asarray(lengths),
                         jnp.asarray(tgt))
    jlog = jm.generator_logits(jp, jout)
    with torch.no_grad():
        tout, none = tm.forward(_t(src), _t(lengths), _t(tgt))
        tlog = tm.generator_logits(tout)
    assert none is None and tout.shape == (B, T - 1, KW["d_model"])
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=1e-5)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-5)


@pytest.mark.parametrize("beam", [3, 15])
def test_translate_matches_jax_step_path(pair, batch, beam):
    """Against the JAX package's XLA step path (eager cache reorder)."""
    jm, jp, tm = pair
    src, lengths, _ = batch
    jr = jm.translate_batch(jp, jnp.asarray(src), jnp.asarray(lengths),
                            beam_size=beam)
    with torch.no_grad():
        tr = tm.translate_batch(_t(src), _t(lengths), beam_size=beam)
    assert tr.seq.shape == (B, beam, KW["max_decode_len"])
    np.testing.assert_array_equal(tr.seq.numpy(), np.asarray(jr.seq))
    np.testing.assert_array_equal(tr.aux.numpy(), np.asarray(jr.aux))
    np.testing.assert_allclose(tr.scores.numpy(), np.asarray(jr.scores),
                               atol=1e-5)


def test_translate_matches_jax_kernel_path(pair, batch, monkeypatch):
    """Against the JAX package's whole-stack Pallas kernel path (interpret
    mode, lazy cache, window cache mode, T padded to 16)."""
    jm, jp, tm = pair
    src, lengths, _ = batch
    monkeypatch.setattr(jnt, "_INTERPRET", True)
    assert jnt._use_stack_kernel(KW["d_model"], KW["num_heads"])
    jr = jm.translate_batch(jp, jnp.asarray(src), jnp.asarray(lengths),
                            beam_size=3)
    with torch.no_grad():
        tr = tm.translate_batch(_t(src), _t(lengths), beam_size=3)
    np.testing.assert_array_equal(tr.seq.numpy(), np.asarray(jr.seq))
    np.testing.assert_array_equal(tr.aux.numpy(), np.asarray(jr.aux))
    np.testing.assert_allclose(tr.scores.numpy(), np.asarray(jr.scores),
                               atol=1e-5)


def test_shared_embeddings_translate(batch):
    jm, jp, tm = _pair(share_decoder_embeddings=True)
    src, lengths, _ = batch
    jr = jm.translate_batch(jp, jnp.asarray(src), jnp.asarray(lengths),
                            beam_size=3)
    with torch.no_grad():
        tr = tm.translate_batch(_t(src), _t(lengths), beam_size=3)
    np.testing.assert_array_equal(tr.seq.numpy(), np.asarray(jr.seq))
    np.testing.assert_allclose(tr.scores.numpy(), np.asarray(jr.scores),
                               atol=1e-5)


def test_make_nmt_model():
    from unpaired_image_captioning_tpu.config import Config
    from unpaired_image_captioning_tpu_torch.models.nmt import NMTModel

    cfg = Config(nmt_src_vocab_size=SRC_V, nmt_tgt_vocab_size=TGT_V,
                 word_vec_size=16, rnn_size=32, layers=2, num_heads=4)
    assert isinstance(tnt.make_nmt_model(cfg, device="cpu"), NMTModel)
    cfg.nmt_model_type = "transformer"
    tm = tnt.make_nmt_model(cfg, device="cpu")
    assert isinstance(tm, tnt.TransformerNMTModel)
    assert (tm.d_model, tm.d_ff, tm.num_layers) == (16, 32, 2)
    jp = jnt.make_nmt_model(cfg).init_params(jax.random.PRNGKey(0))
    tm.init_params(torch.Generator().manual_seed(0))
    assert (jax.tree_util.tree_map(np.shape, bridge.params_to_numpy(tm))
            == jax.tree_util.tree_map(np.shape, jp))


# ---------------------------------------------------------------------------
# onmt_beam_search's lazy caches on a scripted step
# ---------------------------------------------------------------------------

SV, SK, SB, ST = 9, 3, 2, 6
EOS_BIAS = 0.8      # EOS grows likelier with t: the sentences finish at t 2, 4


def _script():
    rs = np.random.RandomState(10)
    f = np.float32
    return dict(emb=rs.randn(SV).astype(f), coef=rs.randn(ST).astype(f),
                table=rs.randn(SV, SV).astype(f), proj=rs.randn(SV).astype(f),
                eos=np.where(np.arange(SV) == C.EOS, EOS_BIAS, 0.0).astype(f),
                off=(2 * rs.randn(SB, SV)).astype(f))


def _torch_step(p, lazy: bool):
    """Writes emb[it] at slot t of the row's cache, then scores the row's
    history (read through anc when lazy) into the next logits."""
    p = {k: torch.from_numpy(v) for k, v in p.items()}

    def step(ctx, state, it):    # ctx["off"]: [R, SV] per-sentence offsets
        t, c = state["t"], state["c"]
        rows = torch.arange(c.shape[0])
        if not lazy:
            c = c.clone()                  # eager caches are reordered
        c[rows, t.long()] = p["emb"][it]
        if lazy:
            phys = (rows - rows % SK)[:, None] + state["anc"].long()
            h = c[phys, torch.arange(ST)[None, :].expand(len(rows), ST)]
        else:
            h = c
        valid = torch.arange(ST)[None, :] <= t[:, None]
        s = (torch.where(valid, h, torch.zeros_like(h)) * p["coef"]).sum(-1)
        logits = (p["table"][it] + s[:, None] * p["proj"]
                  + t[:, None].float() * p["eos"] + ctx["off"])
        new = {"c": c, "t": t + 1}
        if lazy:
            new["anc"] = state["anc"]
        return torch.log_softmax(logits, -1), new

    return step


def _jax_step(p):
    p = {k: jnp.asarray(v) for k, v in p.items()}

    def step(params, ctx, state, it):
        t, c, anc = state["t"], state["c"], state["anc"]
        rows = jnp.arange(c.shape[0])
        c = jnp.where(jnp.arange(ST)[None, :] == t[:, None],
                      p["emb"][it][:, None], c)
        phys = (rows - rows % SK)[:, None] + anc
        h = c[phys, jnp.arange(ST)[None, :]]
        valid = jnp.arange(ST)[None, :] <= t[:, None]
        s = (jnp.where(valid, h, 0.0) * p["coef"]).sum(-1)
        logits = (p["table"][it] + s[:, None] * p["proj"]
                  + t[:, None].astype(jnp.float32) * p["eos"] + ctx["off"])
        return (jax.nn.log_softmax(logits, -1),
                {"c": c, "t": t + 1, "anc": anc})

    return step


def test_onmt_lazy_cache_matches_jax_and_eager():
    p = _script()
    f = dict(beam_size=SK, seq_length=ST, bos_token=C.BOS, eos_token=C.EOS)
    jstate = {"c": jnp.zeros((SB, ST)), "t": jnp.zeros((SB,), jnp.int32),
              "anc": jnp.zeros((SB, ST), jnp.int32)}
    jr = jax.jit(lambda s: jbs.onmt_beam_search(
        _jax_step(p), None, {"off": jnp.asarray(p["off"])}, s,
        lazy_state=("c",), ancestry_key="anc", **f))(jstate)
    state = {"c": torch.zeros((SB, ST)),
             "t": torch.zeros((SB,), dtype=torch.int32),
             "anc": torch.zeros((SB, ST), dtype=torch.int32)}
    ctx = {"off": torch.from_numpy(p["off"])}
    lazy = tbs.onmt_beam_search(_torch_step(p, True), ctx, state,
                                lazy_state=("c",), ancestry_key="anc", **f)
    eager = tbs.onmt_beam_search(
        _torch_step(p, False), ctx,
        {k: v for k, v in state.items() if k != "anc"}, **f)
    # sentences finish at different steps, so frozen rows are exercised
    top = np.asarray(jr.seq)[:, 0]
    assert (top == C.EOS).any(-1).all()
    assert len(set((top == C.EOS).argmax(-1).tolist())) == SB
    for got in (lazy, eager):
        np.testing.assert_array_equal(got.seq.numpy(), np.asarray(jr.seq))
        np.testing.assert_allclose(got.scores.numpy(), np.asarray(jr.scores),
                                   atol=1e-5)
