"""The port's whole-layer training layers (`kernels/layer_train.py`, plain
versions in `ops/layer_train.py`) against the Pallas `fused_enc_layer` and
`fused_dec_layer` in interpret mode: outputs and every `jax.vjp` gradient at
dropout rates 0 and 0.3 (the same splitmix32 masks at the same four sites),
B 2, T 24, d 128, 4 heads, d_ff 128, S 40, with padded and causal masks.
Tolerances: outputs 1e-4 and gradients 1e-3, each times max(1, max|ref|)
(f32 sums over d and d_ff in another order; the gradients pass through
three LayerNorm backward formulas and two attention backwards).

Card tests carry the `cuda` marker and skip without a card. On a card
machine without jax, run them with

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_layer_train.py
"""

import math

import numpy as np
import pytest
import torch

from unpaired_image_captioning_tpu_torch.kernels import layer_train as lk
from unpaired_image_captioning_tpu_torch.ops import layer_train as lo
from unpaired_image_captioning_tpu_torch.ops import mha_train as mo

B, T, D, H, F, S = 2, 24, 128, 4, 128, 40
OUT_TOL, GRAD_TOL = 1e-4, 1e-3
RATES = [0.0, 0.3]
SEED = 91


def _weights(rs, keys):
    sc = 1.0 / math.sqrt(D)
    shapes = {"wqkv": (D, 3 * D), "bqkv": (3 * D,), "wo": (D, D),
              "wq": (D, D), "wo2": (D, D), "w1": (D, F), "b1": (F,),
              "w2": (F, D)}
    w = {}
    for k in keys:
        shape = shapes.get(k, (D,))
        if k.startswith("l") and k.endswith("s"):
            w[k] = 1.0 + 0.1 * rs.randn(*shape)
        elif k.startswith("l"):
            w[k] = 0.1 * rs.randn(*shape)
        elif k.startswith("b"):
            w[k] = 0.02 * rs.randn(*shape)
        else:
            w[k] = sc * rs.randn(*shape)
    return {k: v.astype(np.float32) for k, v in w.items()}


def _enc_inputs():
    rs = np.random.RandomState(0)
    x = rs.randn(B, T, D).astype(np.float32)
    keep = rs.rand(B, 1, T) > 0.15
    keep[:, :, 0] = True
    maskadd = np.where(keep, 0.0, -1e9).astype(np.float32)
    g = rs.randn(B, T, D).astype(np.float32)
    return x, maskadd, g, _weights(rs, lo.ENC_WEIGHTS)


def _dec_inputs():
    rs = np.random.RandomState(1)
    x = rs.randn(B, T, D).astype(np.float32)
    mk, mv = (rs.randn(B, S, D).astype(np.float32) for _ in range(2))
    causal = np.tril(np.ones((T, T), bool))
    pad = rs.rand(B, 1, T) > 0.1
    pad[:, :, 0] = True
    tm = np.where(causal[None] & pad, 0.0, -1e9).astype(np.float32)
    keep = rs.rand(B, 1, S) > 0.15
    keep[1, :, S - 5:] = False
    sm = np.where(keep, 0.0, -1e9).astype(np.float32)
    g = rs.randn(B, T, D).astype(np.float32)
    return x, mk, mv, tm, sm, g, _weights(rs, lo.DEC_WEIGHTS)


def _seeds():
    return np.asarray([SEED, SEED ^ 0x55555555], np.int32)


@pytest.fixture(scope="module")
def enc_ref():
    """The Pallas encoder layer in interpret mode, at each rate: output and
    the vjp of (x, every weight), computed once for the module."""
    import jax
    import jax.numpy as jnp

    from unpaired_image_captioning_tpu.ops.layer_train import fused_enc_layer

    x, maskadd, g, w = _enc_inputs()
    refs = {}
    for rate in RATES:
        def f(x_, *ws):
            return fused_enc_layer(x_, jnp.asarray(maskadd),
                                   jnp.asarray(_seeds()[:1]), *ws, H, rate,
                                   True)

        out, vjp = jax.vjp(f, jnp.asarray(x),
                           *[jnp.asarray(w[k]) for k in lo.ENC_WEIGHTS])
        refs[rate] = (np.asarray(out),
                      [np.asarray(a) for a in vjp(jnp.asarray(g))])
    return refs


@pytest.fixture(scope="module")
def dec_ref():
    """The Pallas decoder layer in interpret mode, at each rate: output and
    the vjp of (x, mk, mv, every weight)."""
    import jax
    import jax.numpy as jnp

    from unpaired_image_captioning_tpu.ops.layer_train import fused_dec_layer

    x, mk, mv, tm, sm, g, w = _dec_inputs()
    refs = {}
    for rate in RATES:
        def f(x_, mk_, mv_, *ws):
            return fused_dec_layer(x_, mk_, mv_, jnp.asarray(tm),
                                   jnp.asarray(sm), jnp.asarray(_seeds()),
                                   *ws, H, rate, True)

        out, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(mk),
                           jnp.asarray(mv),
                           *[jnp.asarray(w[k]) for k in lo.DEC_WEIGHTS])
        refs[rate] = (np.asarray(out),
                      [np.asarray(a) for a in vjp(jnp.asarray(g))])
    return refs


def _close(name, got, want, tol):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), (name, err)


@pytest.mark.parametrize("rate", RATES)
def test_enc_layer_matches_pallas_interpret(enc_ref, rate):
    x, maskadd, g, w = _enc_inputs()
    tx = torch.tensor(x, requires_grad=True)
    tw = [torch.tensor(w[k], requires_grad=True) for k in lo.ENC_WEIGHTS]
    out = lk.enc_layer_train(tx, torch.from_numpy(maskadd),
                             torch.from_numpy(_seeds()[:1]), *tw, n_heads=H,
                             rate=rate)
    out.backward(torch.from_numpy(g))
    ref_out, ref_grads = enc_ref[rate]
    _close("out", out.detach().numpy(), ref_out, OUT_TOL)
    for name, got, want in zip(("x",) + lo.ENC_WEIGHTS,
                               [tx.grad] + [a.grad for a in tw], ref_grads):
        _close("d" + name, got.numpy(), want, GRAD_TOL)


@pytest.mark.parametrize("rate", RATES)
def test_dec_layer_matches_pallas_interpret(dec_ref, rate):
    x, mk, mv, tm, sm, g, w = _dec_inputs()
    tx, tmk, tmv = (torch.tensor(a, requires_grad=True) for a in (x, mk, mv))
    tw = [torch.tensor(w[k], requires_grad=True) for k in lo.DEC_WEIGHTS]
    out = lk.dec_layer_train(tx, tmk, tmv, torch.from_numpy(tm),
                             torch.from_numpy(sm), torch.from_numpy(_seeds()),
                             *tw, n_heads=H, rate=rate)
    out.backward(torch.from_numpy(g))
    ref_out, ref_grads = dec_ref[rate]
    _close("out", out.detach().numpy(), ref_out, OUT_TOL)
    names = ("x", "mk", "mv") + lo.DEC_WEIGHTS
    grads = [tx.grad, tmk.grad, tmv.grad] + [a.grad for a in tw]
    for name, got, want in zip(names, grads, ref_grads):
        _close("d" + name, got.numpy(), want, GRAD_TOL)


def test_keep_mask_keeps_the_attention_masks():
    """The pid mapping's defaults give the attention kernel's masks bit for
    bit (pid = b * H + h), and each site of the whole-layer kernels is the
    Pallas `_keep_mask` at pid = (b * 4 + site) * H + h."""
    import jax.numpy as jnp

    from unpaired_image_captioning_tpu.ops.mha_train import _keep_mask

    seed, t, s, rate = 2_000_000_011, 5, 9, 0.3
    st = torch.tensor([seed], dtype=torch.int32)
    plain = mo.keep_mask(st, B, H, t, s, rate)
    one_site = mo.keep_mask(st, B, H, t, s, rate, n_sites=1, site=0,
                            heads=H)
    assert torch.equal(plain, one_site)
    for b in range(B):
        for h in range(H):
            want = np.asarray(_keep_mask(jnp.int32(seed), b * H + h, t, s,
                                         rate))
            np.testing.assert_array_equal(plain[b, h].numpy(), want)
    for site in range(lo.N_SITES):
        heads = H if site == 0 else 1
        got = mo.keep_mask(st, B, H, t, s, rate, n_sites=lo.N_SITES,
                           site=site, heads=heads)
        for b in range(B):
            for h in range(heads):
                pid = (b * lo.N_SITES + site) * H + h
                want = np.asarray(_keep_mask(jnp.int32(seed), pid, t, s,
                                             rate))
                np.testing.assert_array_equal(got[b, h].numpy(), want)


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _card_close(got, want):
    for a, b in zip(got, want):
        tol = 1e-4 * max(1.0, b.abs().max().item())
        assert (a - b).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,d,f,heads", [(50, 196, 512, 512, 8),
                                           (3, 37, 256, 384, 4),
                                           (50, 16, 512, 2048, 8),
                                           (5, 29, 96, 100, 3),
                                           (4, 37, 768, 512, 8),
                                           (3, 70, 512, 384, 2),
                                           (3, 37, 12, 40, 2),
                                           (3, 29, 100, 200, 2),
                                           (2, 21, 384, 510, 1),
                                           (2, 19, 512, 384, 1),
                                           (3, 29, 30, 45, 5),
                                           (2, 19, 4096, 512, 8)])
def test_cuda_enc_layer_matches_plain(cuda_dev, b, t, d, f, heads):
    gen = torch.Generator(device=cuda_dev).manual_seed(t)
    x, g = (torch.randn((b, t, d), generator=gen, device=cuda_dev)
            for _ in range(2))
    keep = torch.rand((b, 1, t), generator=gen, device=cuda_dev) > 0.2
    keep[:, :, 0] = True
    maskadd = torch.where(keep, 0.0, -1e9).contiguous()
    seed = torch.tensor([4321], dtype=torch.int32, device=cuda_dev)
    w = _card_weights(gen, cuda_dev, lo.ENC_WEIGHTS, d, f)
    kw = dict(n_heads=heads, rate=0.1)
    out, saved = lk.enc_layer_fwd(x, maskadd, seed, w, **kw)
    grads = lk.enc_layer_bwd(x, maskadd, seed, w, saved, g, **kw)
    again = lk.enc_layer_bwd(x, maskadd, seed, w, saved, g, **kw)
    ws = [w[k] for k in lo.ENC_WEIGHTS]
    ref, x2 = lo.enc_fwd_plain(x, maskadd, seed, *ws, **kw)
    # on the kernel's relu pattern: a pre-activation within rounding of 0
    # may fall on either side of the kink
    refs = lo.enc_bwd_plain(x, maskadd, seed, x2, g, *ws, **kw,
                            relu_active=saved[-1] > 0)
    torch.cuda.synchronize()
    _card_close((out, saved[0]) + grads, (ref, x2) + refs)
    assert all(torch.equal(a, c) for a, c in zip(grads, again))


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,s,d,f,heads", [(50, 17, 196, 512, 512, 8),
                                             (3, 9, 70, 256, 384, 4),
                                             (4, 17, 196, 768, 512, 8),
                                             (3, 17, 196, 512, 512, 2),
                                             (3, 9, 70, 12, 40, 2),
                                             (3, 9, 70, 100, 510, 2),
                                             (2, 9, 50, 384, 256, 1),
                                             (2, 9, 50, 512, 384, 1),
                                             (3, 9, 70, 30, 45, 5)])
def test_cuda_dec_layer_matches_plain(cuda_dev, b, t, s, d, f, heads):
    gen = torch.Generator(device=cuda_dev).manual_seed(s)
    x, g = (torch.randn((b, t, d), generator=gen, device=cuda_dev)
            for _ in range(2))
    mk, mv = (torch.randn((b, s, d), generator=gen, device=cuda_dev)
              for _ in range(2))
    pos = torch.arange(t, device=cuda_dev)
    tm = torch.where((pos[None, :] <= pos[:, None])[None].expand(b, t, t),
                     0.0, -1e9).contiguous()
    keep = torch.rand((b, 1, s), generator=gen, device=cuda_dev) > 0.2
    keep[:, :, 0] = True
    sm = torch.where(keep, 0.0, -1e9).contiguous()
    seeds = torch.tensor([4321, 4321 ^ 0x55555555], dtype=torch.int32,
                         device=cuda_dev)
    w = _card_weights(gen, cuda_dev, lo.DEC_WEIGHTS, d, f)
    kw = dict(n_heads=heads, rate=0.1)
    out, saved = lk.dec_layer_fwd(x, mk, mv, tm, sm, seeds, w, **kw)
    grads = lk.dec_layer_bwd(x, mk, mv, tm, sm, seeds, w, saved, g, **kw)
    again = lk.dec_layer_bwd(x, mk, mv, tm, sm, seeds, w, saved, g, **kw)
    ws = [w[k] for k in lo.DEC_WEIGHTS]
    ref, x2, x3 = lo.dec_fwd_plain(x, mk, mv, tm, sm, seeds, *ws, **kw)
    refs = lo.dec_bwd_plain(x, mk, mv, tm, sm, seeds, x2, x3, g, *ws, **kw,
                            relu_active=saved[-1] > 0)
    torch.cuda.synchronize()
    _card_close((out, saved[0], saved[1]) + grads, (ref, x2, x3) + refs)
    assert all(torch.equal(a, c) for a, c in zip(grads, again))


def _card_weights(gen, dev, keys, d, f):
    shapes = {"wqkv": (d, 3 * d), "bqkv": (3 * d,), "wo": (d, d),
              "wq": (d, d), "wo2": (d, d), "w1": (d, f), "b1": (f,),
              "w2": (f, d)}
    w = {}
    for k in keys:
        r = torch.randn(shapes.get(k, (d,)), generator=gen, device=dev)
        w[k] = (1 + 0.1 * r if k.startswith("l") and k.endswith("s")
                else r * (0.1 if k.startswith(("l", "b")) else d ** -0.5))
    return w


def _bf16_scaled(got, want, tol=1e-2):
    """bf16: each tensor max|diff| <= tol * max(1, max|plain|)."""
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        a, b = a.float(), b.float()
        assert (a - b).abs().max().item() <= tol * max(1.0,
                                                       b.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,d,f,heads", [(50, 196, 512, 512, 8),
                                           (50, 16, 512, 2048, 8),
                                           (3, 29, 30, 45, 5)])
def test_cuda_enc_layer_bf16_matches_plain(cuda_dev, b, t, d, f, heads):
    """The bf16 entry (x, the weights and g bf16) against the plain version
    at rtol = atol = 1e-2 against each tensor's scale, the backward from
    the kernel's residual x2 on its relu pattern; a bf16 launch each way."""
    gen = torch.Generator(device=cuda_dev).manual_seed(t)
    bf = torch.bfloat16
    x, g = (torch.randn((b, t, d), generator=gen, device=cuda_dev).to(bf)
            for _ in range(2))
    keep = torch.rand((b, 1, t), generator=gen, device=cuda_dev) > 0.2
    keep[:, :, 0] = True
    maskadd = torch.where(keep, 0.0, -1e9).contiguous()
    seed = torch.tensor([4321], dtype=torch.int32, device=cuda_dev)
    w = {k: v.to(bf) for k, v in _card_weights(gen, cuda_dev, lo.ENC_WEIGHTS,
                                              d, f).items()}
    kw = dict(n_heads=heads, rate=0.1)
    before = (lk.bf16_enc_fwd_launches, lk.bf16_enc_bwd_launches)
    out, saved = lk.enc_layer_fwd(x, maskadd, seed, w, **kw)
    grads = lk.enc_layer_bwd(x, maskadd, seed, w, saved, g, **kw)
    ws = [w[k] for k in lo.ENC_WEIGHTS]
    ref, x2 = lo.enc_fwd_plain(x, maskadd, seed, *ws, **kw)
    refs = lo.enc_bwd_plain(x, maskadd, seed, saved[0].to(bf), g, *ws, **kw,
                            relu_active=saved[-1] > 0)
    torch.cuda.synchronize()
    assert (lk.bf16_enc_fwd_launches, lk.bf16_enc_bwd_launches) == (
        before[0] + 1, before[1] + 1)
    assert saved[0].dtype == torch.float32 and out.dtype == bf
    _bf16_scaled((out, saved[0]) + grads, (ref, x2.float()) + refs)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,s,d,f,heads", [(50, 17, 196, 512, 512, 8),
                                             (3, 9, 70, 30, 45, 5)])
def test_cuda_dec_layer_bf16_matches_plain(cuda_dev, b, t, s, d, f, heads):
    """The decoder layer's bf16 entry, as the encoder's."""
    gen = torch.Generator(device=cuda_dev).manual_seed(s)
    bf = torch.bfloat16
    x, g = (torch.randn((b, t, d), generator=gen, device=cuda_dev).to(bf)
            for _ in range(2))
    mk, mv = (torch.randn((b, s, d), generator=gen, device=cuda_dev).to(bf)
              for _ in range(2))
    pos = torch.arange(t, device=cuda_dev)
    tm = torch.where((pos[None, :] <= pos[:, None])[None].expand(b, t, t),
                     0.0, -1e9).contiguous()
    keep = torch.rand((b, 1, s), generator=gen, device=cuda_dev) > 0.2
    keep[:, :, 0] = True
    sm = torch.where(keep, 0.0, -1e9).contiguous()
    seeds = torch.tensor([4321, 4321 ^ 0x55555555], dtype=torch.int32,
                         device=cuda_dev)
    w = {k: v.to(bf) for k, v in _card_weights(gen, cuda_dev, lo.DEC_WEIGHTS,
                                              d, f).items()}
    kw = dict(n_heads=heads, rate=0.1)
    out, saved = lk.dec_layer_fwd(x, mk, mv, tm, sm, seeds, w, **kw)
    grads = lk.dec_layer_bwd(x, mk, mv, tm, sm, seeds, w, saved, g, **kw)
    ws = [w[k] for k in lo.DEC_WEIGHTS]
    ref, x2, x3 = lo.dec_fwd_plain(x, mk, mv, tm, sm, seeds, *ws, **kw)
    refs = lo.dec_bwd_plain(x, mk, mv, tm, sm, seeds, saved[0].to(bf),
                            saved[1].to(bf), g, *ws, **kw,
                            relu_active=saved[-1] > 0)
    torch.cuda.synchronize()
    _bf16_scaled((out, saved[0], saved[1]) + grads,
                 (ref, x2.float(), x3.float()) + refs)
