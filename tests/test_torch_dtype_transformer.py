"""PyTorch port, the compute dtype's transformer part (ROADMAP A15) against
the JAX package on the CPU, at 2 layers, d 32, 4 heads:

- (a) the bf16 plain versions of the transformer kernels against the
  Pallas kernels in interpret mode, in each dtype mixture the routes give:
  B8 `fused_layer_norm` (x bf16 with bf16 or f32 parameters), B5
  `fused_mha_train`, B6 `fused_enc_layer`, B7 `fused_dec_layer` (outputs
  and every `jax.vjp` gradient, dropout 0 and 0.3), B4 `decoder_stack_step`
  and `decoder_layer_step` (f32 weights over bf16 caches and memory, and
  every operand bf16); and B11's bf16 store against JAX's
  `resize_normalize(out_dtype=bfloat16)`, bit for bit at the identity size;
- (b) the cast route, what `Trainer._cast_compute` gives on a TPU: the JAX
  trees cast to bf16 around `Trainer._loss_terms` (JAX's XLA route on the
  CPU), against the port's `Trainer` with its cast route forced on the
  CPU (`bf16_params`, the kernels' plain versions): the transformer
  captioner's XE loss and gradients on each training route, its SCST loss
  on given samples, and the transformer NMT's XE step.

Tolerance: rtol = atol = 1e-2, JAX's bf16 tolerance
(`tests/test_ln_train.py:61-71`): elementwise (|diff| <= 1e-2 + 1e-2 |ref|)
for the LayerNorm, the attention, the image front end and every loss; for
the whole layers, the decoder step and the gradients of a training step
against the tensor's scale, |diff| <= 1e-2 max(1, max|ref|) (the form of
the repo's f32 layer checks and of `chip_smoke.py`'s gradient checks):
there a residual stream of magnitude 4-8 holds bf16 values 2^-5 apart, so
one rounding that a sum in another order takes the other way moves an
element by 0.03, past an elementwise atol of 1e-2 wherever the layer's
output cancels to near 0. Dropout is 0 where the two packages draw
different streams (the training routes); the kernels' own splitmix32
masks are the same bits on both sides.
"""

import math

import numpy as np
import pytest
import torch

from unpaired_image_captioning_tpu_torch import bridge
from unpaired_image_captioning_tpu_torch.config import Config as TConfig
from unpaired_image_captioning_tpu_torch.kernels import image as imk
from unpaired_image_captioning_tpu_torch.kernels import layer_train as ltk
from unpaired_image_captioning_tpu_torch.kernels import ln_train as lnk
from unpaired_image_captioning_tpu_torch.kernels import mha_train as mhk
from unpaired_image_captioning_tpu_torch.kernels import (
    transformer_decode as tdk)
from unpaired_image_captioning_tpu_torch.ops import layer_train as lto
from unpaired_image_captioning_tpu_torch.ops import (
    transformer_decode as tdo)
from unpaired_image_captioning_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)
TOL = 1e-2        # rtol = atol: JAX's bf16 tolerance
B, T, D, H, F, S = 2, 8, 32, 4, 32, 12
SEED = 91
V = 20
CAP = dict(caption_model="transformer", vocab_size=V, input_encoding_size=D,
           rnn_size=F, num_layers=2, num_heads=H, att_hid_size=D,
           fc_feat_size=16, att_feat_size=16, seq_length=5, batch_size=3,
           seq_per_img=1, i2t_train_flag=True, i2t_max_grad_norm=5.0,
           i2t_learning_rate=5e-4, drop_prob_lm=0.0, i2t_optim_epsilon=1e-6)
NMT = dict(vocab_size=0, nmt_src_vocab_size=31, nmt_tgt_vocab_size=29,
           nmt_model_type="transformer", word_vec_size=D, rnn_size=F,
           layers=2, num_heads=H, dropout=0.0, batch_size=3,
           nmt_train_flag=True, i2t_train_flag=False, nmt_optim="adam",
           nmt_learning_rate=1e-3, nmt_optim_epsilon=1e-6,
           nmt_max_grad_norm=5.0, seed=7)
BF = "bf16"


def _bf16(a):
    import ml_dtypes

    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16)


def _np(t):
    return t.detach().float().numpy()


def _close(got, want, what, tol=TOL):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


def _close_scaled(got, want, what, tol=TOL):
    """max|got - want| <= tol * max(1, max|want|), one tensor."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= tol * max(1.0, np.abs(want).max()), (what, err)


def _t(a, kind):
    """A numpy array as a port tensor of `kind` (f32 or bf16)."""
    t = torch.from_numpy(np.asarray(a, np.float32))
    return t.to(torch.bfloat16) if kind == BF else t


def _j(a, kind):
    import jax.numpy as jnp

    return jnp.asarray(_bf16(a) if kind == BF else np.asarray(a, np.float32))


# ---------------------------------------------------------------------------
# (a) the plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mix", [(BF, BF), (BF, "f32")], ids="/".join)
def test_ln_plain_mixtures_match_pallas(mix):
    """B8: y, dx (in x's type) and d_scale / d_offset (in scale's)."""
    import jax

    from unpaired_image_captioning_tpu.ops.ln_train import fused_layer_norm

    mx, mp = mix
    rs = np.random.RandomState(0)
    x = rs.randn(B, S, D) * 3 + 1
    scale, offset = 1 + 0.1 * rs.randn(D), 0.1 * rs.randn(D)
    g = rs.randn(B, S, D)
    y, vjp = jax.vjp(lambda a, s, o: fused_layer_norm(a, s, o, 1e-6, True),
                     _j(x, mx), _j(scale, mp), _j(offset, mp))
    want = (y,) + vjp(_j(g, mx))
    tx, ts, to = _t(x, mx), _t(scale, mp), _t(offset, mp)
    got = (lnk.ln_train_fwd(tx, ts, to),) + lnk.ln_train_bwd(tx, ts,
                                                              _t(g, mx))
    for name, a, b in zip(("y", "dx", "d_scale", "d_offset"), got, want):
        assert a.dtype == (torch.bfloat16 if str(b.dtype) == "bfloat16"
                           else torch.float32), name
        _close(_np(a), np.asarray(b, np.float32), name)


def _mha_inputs(t, s, causal):
    rs = np.random.RandomState(t + s)
    q, g = rs.randn(B, t, D), rs.randn(B, t, D)
    k, v = rs.randn(B, s, D), rs.randn(B, s, D)
    keep = rs.rand(B, 1, s) > 0.2
    keep[:, :, 0] = True
    if causal:
        keep = keep & np.tril(np.ones((t, s), bool))[None]
    maskadd = np.where(keep, 0.0, -1e9).astype(np.float32)
    return q, k, v, g, maskadd


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("t,s,causal", [(S, S, False), (T, S, False),
                                        (T, T, True)])
def test_mha_plain_bf16_matches_pallas(t, s, causal, rate):
    """B5 on bf16 q / k / v: the output and dq / dk / dv, all bf16."""
    import jax
    import jax.numpy as jnp

    from unpaired_image_captioning_tpu.ops.mha_train import fused_mha_train

    q, k, v, g, maskadd = _mha_inputs(t, s, causal)
    seed = np.asarray([SEED], np.int32)
    out, vjp = jax.vjp(
        lambda a, b_, c: fused_mha_train(a, b_, c, jnp.asarray(maskadd),
                                         jnp.asarray(seed), H, rate, True),
        _j(q, BF), _j(k, BF), _j(v, BF))
    want = (out,) + vjp(_j(g, BF))
    tq, tk, tv = _t(q, BF), _t(k, BF), _t(v, BF)
    tm, ts = torch.from_numpy(maskadd), torch.from_numpy(seed)
    o, stats = mhk.mha_train_fwd(tq, tk, tv, tm, ts, n_heads=H, rate=rate)
    got = (o,) + mhk.mha_train_bwd(tq, tk, tv, tm, ts, _t(g, BF), o, stats,
                                   n_heads=H, rate=rate)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16, name
        _close(_np(a), np.asarray(b, np.float32), name)


def _weights(rs, keys):
    shapes = {"wqkv": (D, 3 * D), "bqkv": (3 * D,), "wo": (D, D),
              "wq": (D, D), "wo2": (D, D), "w1": (D, F), "b1": (F,),
              "w2": (F, D)}
    w = {}
    for k in keys:
        shape = shapes.get(k, (D,))
        if k.startswith("l") and k.endswith("s"):
            w[k] = 1.0 + 0.1 * rs.randn(*shape)
        elif k.startswith(("l", "b")):
            w[k] = 0.1 * rs.randn(*shape)
        else:
            w[k] = rs.randn(*shape) / math.sqrt(D)
    return w


def _pallas_relu(xa, ls, lb, w1, b1):
    """The relu decisions the Pallas backward takes: its pre-activations
    `_linear(_ln(xa))` (> 0) recomputed from its own saved residual xa,
    one batch element at a time as the kernel's programs compute them."""
    from unpaired_image_captioning_tpu.ops import layer_train as jlt

    rows = []
    for i in range(xa.shape[0]):
        y, *_ = jlt._ln(xa[i], ls, lb)
        rows.append(np.asarray(jlt._linear(y, w1, b1[None], xa.dtype),
                               np.float32))
    return np.stack(rows)


def _plain_relu(xa, ls, lb, w1, b1):
    """The plain version's pre-activations over xa (f32 values)."""
    from unpaired_image_captioning_tpu_torch.ops.ln_train import (
        ln_train_plain)

    return lto._lin(ln_train_plain(xa, ls, lb, lto.EPS), w1, b1,
                    xa.dtype).float().numpy()


def _relu_active(pallas_h, plain_h):
    """The Pallas kernel's relu pattern, for the plain backward: a
    pre-activation within rounding of 0 may fall on either side of the
    kink in two sums of another order (bf16: 2^-8 of the largest), and the
    gradients are compared on one pattern; any other disagreement fails."""
    differ = (pallas_h > 0) != (plain_h > 0)
    near = np.abs(pallas_h) <= 2.0 ** -7 * max(1.0, np.abs(pallas_h).max())
    assert not (differ & ~near).any(), int((differ & ~near).sum())
    return torch.from_numpy(pallas_h > 0)


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_enc_layer_plain_bf16_matches_pallas(rate):
    """B6, every operand bf16: the output, and the gradients of x and of
    each weight (in the weight's type, bf16) from the Pallas forward's
    saved residual x2 (both backwards recompute the layer from it), on the
    Pallas kernel's relu pattern (`_relu_active`)."""
    import jax
    import jax.numpy as jnp

    from unpaired_image_captioning_tpu.ops import layer_train as jlt

    rs = np.random.RandomState(1)
    x, g = rs.randn(B, S, D), rs.randn(B, S, D)
    keep = rs.rand(B, 1, S) > 0.2
    keep[:, :, 0] = True
    maskadd = np.where(keep, 0.0, -1e9).astype(np.float32)
    keys = lto.ENC_WEIGHTS
    w = _weights(rs, keys)
    seed = np.asarray([SEED], np.int32)
    jw = [_j(w[k], BF) for k in keys]
    jargs = (_j(x, BF), jnp.asarray(maskadd), jnp.asarray(seed))
    out, vjp = jax.vjp(lambda x_, *ws: jlt.fused_enc_layer(
        x_, *jargs[1:], *ws, H, rate, True), jargs[0], *jw)
    want = (out,) + vjp(_j(g, BF))
    x2j = jlt._layer_fwd(*jargs, *jw, H, rate, True)[1][-1]
    tw = [_t(w[k], BF) for k in keys]
    ta = (_t(x, BF), torch.from_numpy(maskadd), torch.from_numpy(seed))
    o, x2 = lto.enc_fwd_plain(*ta, *tw, n_heads=H, rate=rate)
    wd = dict(zip(keys, tw))
    active = _relu_active(
        _pallas_relu(x2j, jw[keys.index("l2s")], jw[keys.index("l2b")],
                     jw[keys.index("w1")], jw[keys.index("b1")]),
        _plain_relu(x2, wd["l2s"], wd["l2b"], wd["w1"], wd["b1"]))
    grads = lto.enc_bwd_plain(*ta, _t(np.asarray(x2j, np.float32), BF),
                              _t(g, BF), *tw, n_heads=H, rate=rate,
                              relu_active=active)
    for name, a, b in zip(("out", "dx") + keys, (o,) + grads, want):
        assert a.dtype == torch.bfloat16, name
        _close_scaled(_np(a), np.asarray(b, np.float32), name)


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_dec_layer_plain_bf16_matches_pallas(rate):
    """B7, every operand bf16: the output, and the gradients of x, mk, mv
    and each weight from the Pallas forward's saved residuals x2 and x3,
    on the Pallas kernel's relu pattern."""
    import jax
    import jax.numpy as jnp

    from unpaired_image_captioning_tpu.ops import layer_train as jlt

    rs = np.random.RandomState(2)
    x, g = rs.randn(B, T, D), rs.randn(B, T, D)
    mk, mv = rs.randn(B, S, D), rs.randn(B, S, D)
    pad = rs.rand(B, 1, T) > 0.1
    pad[:, :, 0] = True
    tmask = np.where(np.tril(np.ones((T, T), bool))[None] & pad, 0.0,
                     -1e9).astype(np.float32)
    keep = rs.rand(B, 1, S) > 0.2
    keep[:, :, 0] = True
    smask = np.where(keep, 0.0, -1e9).astype(np.float32)
    keys = lto.DEC_WEIGHTS
    w = _weights(rs, keys)
    seeds = np.asarray([SEED, SEED ^ 0x55555555], np.int32)
    jw = [_j(w[k], BF) for k in keys]
    jargs = (_j(x, BF), _j(mk, BF), _j(mv, BF), jnp.asarray(tmask),
             jnp.asarray(smask), jnp.asarray(seeds))
    out, vjp = jax.vjp(
        lambda x_, k_, v_, *ws: jlt.fused_dec_layer(
            x_, k_, v_, *jargs[3:], *ws, H, rate, True),
        *jargs[:3], *jw)
    want = (out,) + vjp(_j(g, BF))
    x2j, x3j = jlt._dec_fwd(*jargs, *jw, H, rate, True)[1][-2:]
    tw = [_t(w[k], BF) for k in keys]
    ta = (_t(x, BF), _t(mk, BF), _t(mv, BF), torch.from_numpy(tmask),
          torch.from_numpy(smask), torch.from_numpy(seeds))
    o, x2, x3 = lto.dec_fwd_plain(*ta, *tw, n_heads=H, rate=rate)
    wd = dict(zip(keys, tw))
    active = _relu_active(
        _pallas_relu(x3j, jw[keys.index("l3s")], jw[keys.index("l3b")],
                     jw[keys.index("w1")], jw[keys.index("b1")]),
        _plain_relu(x3, wd["l3s"], wd["l3b"], wd["w1"], wd["b1"]))
    grads = lto.dec_bwd_plain(*ta, _t(np.asarray(x2j, np.float32), BF),
                              _t(np.asarray(x3j, np.float32), BF),
                              _t(g, BF), *tw, n_heads=H, rate=rate,
                              relu_active=active)
    names = ("out", "dx", "dmk", "dmv") + keys
    for name, a, b in zip(names, (o,) + grads, want):
        assert a.dtype == torch.bfloat16, name
        _close_scaled(_np(a), np.asarray(b, np.float32), name)


def _decode_inputs(n_layers, mix):
    """Decoder-step inputs in the mixture (x, weights, caches, memory)."""
    rs = np.random.RandomState(n_layers)
    kb, n_t = 3, 16
    rows = B * kb
    w = {}
    for k in tdo.WKEYS:
        shape = {"wqkv": (D, 3 * D), "bqkv": (3 * D,), "wo_s": (D, D),
                 "wq_c": (D, D), "wo_c": (D, D), "w1": (D, F), "b1": (F,),
                 "w2": (F, D)}.get(k, (D,))
        scale = (1.0 / math.sqrt(shape[0]) if len(shape) == 2
                 else 0.1)
        w[k] = scale * rs.randn(n_layers, *shape) + (k.startswith("ln")
                                                      and k.endswith("_s"))
    t = rs.randint(0, n_t, rows).astype(np.int32)
    t[0], t[-1] = 0, n_t - 1
    mask = np.ones((B, S), np.float32)
    mask[0, 7:] = 0.0
    return dict(w=w, x=rs.randn(rows, D), t=t,
                ck=rs.randn(n_layers, B, S, D), cv=rs.randn(n_layers, B, S, D),
                mask=mask, kc=rs.randn(rows, n_layers, n_t, D),
                vc=rs.randn(rows, n_layers, n_t, D))


def _jax_step(a, mix, layers, kernel):
    """JAX's step over `layers` layers: the Pallas stack / layer kernel in
    interpret mode (kernel), or its math `_layer_math` on values, layer by
    layer (the mixture of f32 x over bf16 caches, which the Pallas kernel
    cannot store: its f32 cache write into a bf16 cache raises a `swap`
    dtype error, so its math is the reference there)."""
    import jax.numpy as jnp

    from unpaired_image_captioning_tpu.ops import transformer_decode as jtd

    mx, mw, mc, mm = mix
    kb = a["x"].shape[0] // B
    x, t = _j(a["x"], mx), jnp.asarray(a["t"])
    ks, vs = [], []
    for li in range(layers):
        jw = {k: _j(v[li], mw) for k, v in a["w"].items()}
        jw = {k: (v[None] if k[0] == "b" or k.startswith("ln") else v)
              for k, v in jw.items()}
        ck, cv = _j(a["ck"][li], mm), _j(a["cv"][li], mm)
        kc, vc = _j(a["kc"][:, li], mc), _j(a["vc"][:, li], mc)
        if kernel:
            x, kc, vc = jtd.decoder_layer_step(
                x, t, ck, cv, jnp.asarray(a["mask"]), kc, vc, jw,
                n_heads=H, interpret=True)
        else:
            ct = kc.dtype
            x, kc, vc, *_ = jtd._layer_math(
                x, t[:, None], ck, cv, jnp.asarray(a["mask"]), kc, vc, jw,
                n_heads=H, bi=B, kb=kb)
            kc, vc = kc.astype(ct), vc.astype(ct)
        ks.append(kc)
        vs.append(vc)
    return x, jnp.stack(ks, 1), jnp.stack(vs, 1)


@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("mix", tdk.MIXTURES[1:], ids="/".join)
def test_decode_plain_mixtures_match_pallas(mix, layers):
    """B4: x' and the caches written at slot t (in their own type), as one
    layer (`decoder_layer_step`) and as a stack of 2 (`decoder_stack_step`,
    against the layer kernel twice). Every operand bf16 against the Pallas
    kernel in interpret mode; f32 x and weights over bf16 caches and memory
    against the kernel's math (`_jax_step`), whose one difference from the
    plain version is the step's own k_t / v_t: JAX attends over their f32
    values where the plain version (and the CUDA kernel) reads them back
    from the bf16 cache, as JAX's own XLA decode step does."""
    mx, mw, mc, mm = mix
    a = _decode_inputs(layers, mix)
    want = _jax_step(a, mix, layers, kernel=mc == mx)
    if layers == 1:
        tw = {k: _t(v[0], mw) for k, v in a["w"].items()}
        got = tdk.decoder_layer_step(
            _t(a["x"], mx), torch.from_numpy(a["t"]), _t(a["ck"][0], mm),
            _t(a["cv"][0], mm), torch.from_numpy(a["mask"]),
            _t(a["kc"][:, 0], mc), _t(a["vc"][:, 0], mc), tw, n_heads=H)
        got = (got[0], got[1][:, None], got[2][:, None])
    else:
        tw = {k: _t(v, mw) for k, v in a["w"].items()}
        got = tdk.decoder_stack_step(
            _t(a["x"], mx), torch.from_numpy(a["t"]), _t(a["ck"], mm),
            _t(a["cv"], mm), torch.from_numpy(a["mask"]), _t(a["kc"], mc),
            _t(a["vc"], mc), tw, n_heads=H)
    for name, g_, w_ in zip(("x", "cache_k", "cache_v"), got, want):
        assert str(g_.dtype).endswith(str(w_.dtype)), (name, g_.dtype,
                                                        w_.dtype)
        _close_scaled(_np(g_), np.asarray(w_, np.float32), name)


@pytest.mark.parametrize("size", [(32, 32), (40, 48)],
                         ids=["identity", "downscale"])
def test_resize_normalize_bf16_matches_jax(size):
    """B11's bf16 store against JAX's `resize_normalize(out_dtype=
    bfloat16)`, on its dense route and on the Pallas kernel in interpret
    mode: bit for bit where the resize is the identity, at TOL where it
    resizes."""
    import jax.numpy as jnp

    from unpaired_image_captioning_tpu.ops.image import resize_normalize

    h, w_ = size
    imgs = np.random.RandomState(h).randint(0, 256, (2, h, w_, 3)).astype(
        np.uint8)
    got = imk.resize_normalize(torch.from_numpy(imgs), h_out=32, w_out=32,
                               out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    for pallas in (False, True):
        want = resize_normalize(jnp.asarray(imgs), h_out=32, w_out=32,
                                use_pallas=pallas, out_dtype=jnp.bfloat16)
        assert str(want.dtype) == "bfloat16"
        if size == (32, 32):
            np.testing.assert_array_equal(
                got.view(torch.int16).numpy(),
                np.asarray(want).view(np.int16))
        else:
            _close(_np(got), np.asarray(want, np.float32), f"pallas {pallas}")


# ---------------------------------------------------------------------------
# (b) the cast route against JAX's cast trees
# ---------------------------------------------------------------------------

def _cast(tree):
    """JAX's `_cast_compute`: every f32 leaf to bf16."""
    import jax
    import jax.numpy as jnp

    return jax.tree.map(lambda x: x.astype(jnp.bfloat16)
                        if x.dtype == jnp.float32 else x, tree)


def _cap_batch(seed=0):
    rs = np.random.RandomState(seed)
    n, t = CAP["batch_size"], CAP["seq_length"]
    labels = np.zeros((n, t + 2), np.int64)
    masks = np.zeros((n, t + 2), np.float32)
    for i, length in enumerate((t, 3, 1)):
        labels[i, 1:1 + length] = rs.randint(1, V + 1, length)
        masks[i, :length + 2] = 1.0
    att_masks = np.ones((n, 6), np.float32)
    att_masks[1, 4:] = 0.0
    return {"fc_feats": rs.randn(n, 16).astype(np.float32),
            "att_feats": rs.randn(n, 6, 16).astype(np.float32),
            "att_masks": att_masks, "labels": labels, "masks": masks}


def _jax_batch(batch):
    """The JAX trainer's upload with cfg.dtype bf16: features rounded."""
    import jax.numpy as jnp

    out = {k: jnp.asarray(_bf16(v) if k.endswith("_feats") else v)
           for k, v in batch.items() if k != "nmt"}
    if "nmt" in batch:
        out["nmt"] = {k: jnp.asarray(v) for k, v in batch["nmt"].items()}
    return out


def _port_cast_grads(pt, batch, sc_flag=False):
    """The port's cast route on the CPU: the step's forward and backward
    under `bf16_params`; returns (the metrics, {model: {name: grad}})."""
    pt.cast = True
    metrics = {}
    with pt._compute_params():
        total, _ = pt._losses(batch, sc_flag, pt.i2t_model is not None,
                              pt.nmt_model is not None, 0.0, metrics)
        total.backward()
    metrics["total_loss"] = total
    grads = {key: {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                   for n, p in model.named_parameters()}
             for key, model in pt._models() if model is not None}
    return metrics, grads


def _grads_close(got: dict, tree, what: str):
    """Each gradient at TOL against its scale. One allowance, for the FFN
    relu's kink: a pre-activation within rounding of 0 may fall on either
    side of it in the two packages (their sums run in another order), and
    that decision moves its hidden unit's column of W1 and entry of b1 by
    the unit's whole cotangent; so W1 and b1 may differ past TOL in at most
    one hidden unit an FFN (the same column in both), every other element
    and tensor held at TOL."""
    want = bridge.params_from_jax(tree)
    assert set(got) == set(want), what
    units = {}
    for name, g in got.items():
        assert g.dtype == torch.float32, name     # on the f32 master
        a, b = g.numpy(), want[name].numpy()
        bad = np.abs(a - b) > TOL * max(1.0, np.abs(b).max())
        if not bad.any():
            continue
        assert name.endswith(("ffn.w1.w", "ffn.w1.b")), (what, name)
        cols = np.nonzero(bad)[-1]
        units.setdefault(name.rsplit(".", 1)[0], set()).update(cols.tolist())
    for ffn, cols in units.items():
        assert len(cols) == 1, (what, ffn, sorted(cols))


@pytest.fixture
def no_dropout(monkeypatch):
    from unpaired_image_captioning_tpu.models import transformer as jtr
    from unpaired_image_captioning_tpu_torch.models import transformer as ttr

    monkeypatch.setattr(jtr, "DROPOUT", 0.0)
    monkeypatch.setattr(ttr, "DROPOUT", 0.0)
    return ttr


@pytest.fixture(scope="module")
def jax_xe(tmp_path_factory):
    """JAX's cast-tree XE loss and gradients of the captioner, dropout 0,
    computed once (JAX's CPU route is the same for every port route)."""
    import jax
    import jax.numpy as jnp

    from unpaired_image_captioning_tpu.config import Config
    from unpaired_image_captioning_tpu.models import transformer as jtr
    from unpaired_image_captioning_tpu.train.trainer import Trainer as JT

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtr, "DROPOUT", 0.0)
        jt = JT(Config(**CAP, checkpoint_path=str(
            tmp_path_factory.mktemp("xe"))))
        jb = _jax_batch(_cap_batch())

        def loss(p):
            return jt._loss_terms(_cast(p), None, jb, jnp.float32(0.0),
                                  jax.random.PRNGKey(0), rl=False,
                                  ss_enabled=False)

        (_, jm), gi = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            jt.i2t_params)
    return jt.i2t_params, jm, gi


@pytest.mark.parametrize("route", [(True, False), (False, False),
                                   (True, True)],
                         ids=["whole-encoder-layers", "per-sublayer",
                              "whole-decoder-layers"])
def test_cast_route_transformer_xe_matches_jax(jax_xe, no_dropout, route,
                                               monkeypatch):
    """The transformer captioner's XE loss and its gradients on the f32
    masters, on each training route of the port (B6; B5 and B8; B6 and
    B7), against the JAX trees cast to bf16 around `_loss_terms`."""
    params, jm, gi = jax_xe
    monkeypatch.setattr(no_dropout, "TRAIN_LAYER_KERNEL", route[0])
    monkeypatch.setattr(no_dropout, "TRAIN_DEC_LAYER_KERNEL", route[1])
    pt = Trainer(TConfig(**CAP), device="cpu")
    assert pt.cfg.dtype == "bfloat16"
    pt.i2t_model.load_state_dict(bridge.params_from_jax(params))
    tm, grads = _port_cast_grads(pt, _cap_batch())
    _close(float(tm["i2t_loss"].detach()), float(jm["i2t_loss"]), "loss")
    _grads_close(grads["i2t"], gi, "i2t")


def test_cast_route_transformer_scst_loss_matches_jax(tmp_path, no_dropout,
                                                      monkeypatch):
    """The transformer captioner's SCST loss on given samples (both
    decodes patched to return them) and its gradients, cast route."""
    import jax
    import jax.numpy as jnp

    from unpaired_image_captioning_tpu.config import Config
    from unpaired_image_captioning_tpu.ops import cider as jc
    from unpaired_image_captioning_tpu.train.trainer import Trainer as JT
    from unpaired_image_captioning_tpu_torch.ops import cider as tc
    from unpaired_image_captioning_tpu_torch.scripts.prepro_ngrams import (
        compute_df)

    t = CAP["seq_length"]
    rs = np.random.RandomState(3)
    rows = np.zeros((40, t + 2), np.int64)
    for i in range(len(rows)):
        n = rs.randint(2, t + 3)
        rows[i, :n] = rs.randint(1, V + 1, n)
    start = np.arange(10) * 4 + 1
    df, n_img = compute_df(rows, start, start + 3)
    batch = _cap_batch()
    n = CAP["batch_size"]
    batch.update(gts=rows[:n * 4].reshape(n, 4, -1),
                 gts_masks=np.ones((n, 4), np.float32))
    gen = rows[[0, 5, 9], 1:t + 1].copy()
    gen[gen == 0] = 1
    gen[0, 3:] = 0
    greedy = rs.randint(1, V + 1, (n, t))
    jt = JT(Config(**CAP, checkpoint_path=str(tmp_path)),
            df_table=jc.build_df_table(df, n_img))
    pt = Trainer(TConfig(**CAP), device="cpu",
                 df_table=tc.build_df_table(df, n_img, device="cpu"))
    pt.i2t_model.load_state_dict(bridge.params_from_jax(jt.i2t_params))

    def pick(is_greedy):
        return greedy if is_greedy else gen

    monkeypatch.setattr(type(jt.i2t_model), "sample",
                        lambda self, params, feats, rng, *, greedy=True, **_:
                        (jnp.asarray(pick(greedy), jnp.int32), None))
    monkeypatch.setattr(pt.i2t_model, "sample",
                        lambda feats, *, greedy=True, **_: (
                            torch.from_numpy(pick(greedy)), None))
    jb = _jax_batch(batch)

    def loss(p):
        return jt._loss_terms(_cast(p), None, jb, jnp.float32(0.0),
                              jax.random.PRNGKey(0), rl=True)

    (_, jm), gi = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jt.i2t_params)
    tm, grads = _port_cast_grads(pt, batch, sc_flag=True)
    for key in ("i2t_loss", "avg_reward"):
        _close(float(tm[key].detach()), float(jm[key]), key)
    assert float(jm["i2t_loss"]) != 0.0
    _grads_close(grads["i2t"], gi, "i2t")


def test_cast_route_transformer_nmt_xe_matches_jax(tmp_path, no_dropout):
    """The transformer NMT's XE loss and its gradients, cast route (the
    encoder on the whole-layer kernel's plain version)."""
    import jax
    import jax.numpy as jnp

    from unpaired_image_captioning_tpu.config import Config
    from unpaired_image_captioning_tpu.train.trainer import Trainer as JT

    rs = np.random.RandomState(4)
    lengths = np.array([6, 4, 1], np.int32)
    src = rs.randint(4, 31, (3, 6)).astype(np.int32)
    src[np.arange(6)[None, :] >= lengths[:, None]] = 0
    tgt = np.zeros((3, 7), np.int32)
    for i, n in enumerate((5, 3, 1)):
        tgt[i, 0] = 2
        tgt[i, 1:1 + n] = rs.randint(4, 29, n)
        tgt[i, 1 + n] = 3
    batch = {"nmt": {"src": src, "tgt": tgt, "lengths": lengths}}
    jt = JT(Config(**NMT, checkpoint_path=str(tmp_path)))
    pt = Trainer(TConfig(**NMT), device="cpu")
    pt.nmt_model.load_state_dict(bridge.params_from_jax(jt.nmt_params))
    jb = _jax_batch(batch)

    def loss(p):
        return jt._loss_terms(None, _cast(p), jb, jnp.float32(0.0),
                              jax.random.PRNGKey(0), rl=False,
                              ss_enabled=False)

    (_, jm), gn = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jt.nmt_params)
    tm, grads = _port_cast_grads(pt, batch)
    for key in ("nmt_loss", "nmt_acc"):
        _close(float(tm[key].detach()), float(jm[key]), key)
    _grads_close(grads["nmt"], gn, "nmt")


# ---------------------------------------------------------------------------
# the wrappers' mixtures
# ---------------------------------------------------------------------------

def test_wrappers_name_the_mixtures_they_refuse():
    """Each transformer wrapper raises on a mixture no route gives,
    naming it (the check runs before any launch, so a CPU call of the
    wrapper's check is enough)."""
    x = torch.zeros((2, 3, 4))
    with pytest.raises(ValueError, match="float16"):
        lnk.mixture("ln_train_fwd", x.half(), x[0, 0], x[0, 0])
    with pytest.raises(ValueError, match="offset"):
        lnk.mixture("ln_train_fwd", x, x[0, 0], x[0, 0].bfloat16())
    w = {k: torch.zeros(2) for k in tdo.WKEYS}
    w["w1"] = w["w1"].bfloat16()
    with pytest.raises(ValueError, match="weights"):
        tdk.mixture("decoder_stack_step", x, w, x, x, x, x)
    assert tdk.mixture("decoder_stack_step", x,
                       {k: torch.zeros(2) for k in tdo.WKEYS},
                       x.bfloat16(), x.bfloat16(), x.bfloat16(),
                       x.bfloat16()) == tdk.C_BF | tdk.M_BF
