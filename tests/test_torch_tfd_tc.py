"""B4's typed decoder step (`csrc/transformer_decode.cu`): the fast
attentions over bf16 caches and memory, and the all-bf16 step's products
on `mma.sync` bf16 with f32 sums (`decode_gemm_bf16`).

On the CPU: the routing rule (`kernels/transformer_decode.py::route`:
which mixture and which widths take the fast attentions and the tensor
cores), that a CPU tensor takes the plain version and counts no launch,
and the bf16 plain stack and layer against the JAX package at the
caption path's T 16 / S 196 with the lazy cache and `want_attn`: every
operand bf16 against the Pallas kernels in interpret mode, f32 x and
weights over bf16 caches and memory against their math (`_layer_math`,
layer by layer: the Pallas kernel cannot store an f32 cache entry into a
bf16 cache), as `tests/test_torch_dtype_transformer.py` holds the same
plain versions at T 8 / S 12 without either. Tolerance: max|got - want|
<= 1e-2 max(1, max|want|) per tensor, that file's `_close_scaled`.

On a card: the kernel against its plain version in both bf16 mixtures of
the path and the others, at the path's shapes and the tiling's edges,
stack and layer within 1e-2 of each output's scale; the route each call
reports and the `tc_*_launches` counts against the rule; a want_attn
rerun bit for bit. Card tests carry the `cuda` marker and skip without a
card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_tfd_tc.py
"""

import math

import numpy as np
import pytest
import torch

from unpaired_image_captioning_tpu_torch.kernels import (
    transformer_decode as tdk)
from unpaired_image_captioning_tpu_torch.ops import (
    transformer_decode as tdo)

BF16, F32 = torch.bfloat16, torch.float32
TOL = 1e-2
# the type flags of the mixtures (x, weights, caches, memory)
ALL_F32 = 0
SERVE = tdk.C_BF | tdk.M_BF                     # f32 x and weights
ALL_BF16 = tdk.X_BF | tdk.W_BF | tdk.C_BF | tdk.M_BF
X_BF16 = tdk.X_BF | tdk.C_BF | tdk.M_BF         # f32 weights
XW_BF16 = tdk.X_BF | tdk.W_BF                   # f32 caches and memory
FAST = tdk.ROUTE_SELF | tdk.ROUTE_CROSS
TC = FAST | tdk.ROUTE_TC


# (d, d_ff, heads, T, S): the route of each mixture
@pytest.mark.parametrize("shape,routes", [
    # the path: the caption beams and the SCST batch (S 196), the NMT
    ((512, 512, 8, 16, 196), (FAST, FAST, FAST, TC, TC)),
    ((512, 2048, 8, 20, 16), (FAST, FAST, FAST, TC, TC)),
    # head widths 96, 256 (caption and NMT), 512
    ((768, 768, 8, 16, 196), (FAST, FAST, FAST, TC, TC)),
    ((512, 512, 2, 16, 196), (FAST, FAST, FAST, TC, TC)),
    ((512, 2048, 2, 20, 16), (FAST, FAST, FAST, TC, TC)),
    ((512, 512, 1, 16, 196), (FAST, FAST, FAST, TC, TC)),
    # one slice of 64 slots at dh 512: only bf16 K and V fit a block
    ((512, 512, 1, 16, 64), (tdk.ROUTE_SELF, FAST, FAST, TC,
                             tdk.ROUTE_SELF)),
    # d 20 and d_ff 510: fast attentions, products off the tensor cores
    ((20, 40, 5, 16, 196), (FAST,) * 5),
    ((512, 510, 8, 16, 196), (FAST,) * 5),
    # head widths off 4: the scalar attentions, so no tensor cores
    ((12, 12, 2, 16, 196), (0,) * 5),
    ((100, 510, 2, 20, 16), (0,) * 5),
    # a cache past a warp's shared memory; heads past a block's
    ((512, 512, 1, 4000, 16), (tdk.ROUTE_CROSS,) * 5),
    ((7300, 64, 1, 8, 8), (0,) * 5),
    ((6000, 64, 1, 8, 500), (tdk.ROUTE_SELF,) * 5),
], ids=["caption", "nmt", "dh96", "dh256", "dh256_nmt", "dh512",
        "dh512_S64", "d20", "dff510", "dh6", "dh50", "T4000", "dh7300",
        "dh6000_S500"])
def test_routing_rule(shape, routes):
    for fl, want in zip((ALL_F32, SERVE, X_BF16, ALL_BF16, XW_BF16), routes):
        assert tdk.route(fl, *shape) == want, (fl, shape)


def _inputs(rs, bsz, kb, n_layers, n_t, slots, d, dff, lazy):
    """numpy decoder-step inputs: weights at the models' scales, a ragged
    mask (image 1 past half its slots), caches holding earlier positions;
    lazy: one t for all rows and the ancestry of a random beam history
    (onmt_beam_search's update), else staggered t with 0 and T - 1."""
    rows = bsz * kb
    w = {}
    for k in tdo.WKEYS:
        shape = {"wqkv": (d, 3 * d), "bqkv": (3 * d,), "wo_s": (d, d),
                 "wq_c": (d, d), "wo_c": (d, d), "w1": (d, dff),
                 "b1": (dff,), "w2": (dff, d)}.get(k, (d,))
        scale = 1.0 / math.sqrt(shape[0]) if len(shape) == 2 else 0.1
        w[k] = (scale * rs.randn(n_layers, *shape)
                + (k.startswith("ln") and k.endswith("_s")))
    mask = np.ones((bsz, slots), np.float32)
    mask[1, slots // 2:] = 0.0
    local = np.arange(rows) % kb
    if lazy:
        t_now = n_t - 4
        t = np.full((rows,), t_now, np.int32)
        anc = np.repeat(local[:, None], n_t, axis=1)
        base = (np.arange(bsz) * kb)[:, None]
        for step in range(t_now):
            parent = rs.randint(0, kb, (bsz, kb))
            re = anc[(base + parent).reshape(-1)]
            anc = np.where(np.arange(n_t)[None, :] <= step, re,
                           local[:, None])
        anc = anc.astype(np.int32)
    else:
        t = rs.randint(0, n_t, rows).astype(np.int32)
        t[0], t[-1] = 0, n_t - 1
        anc = None
    return dict(w=w, x=rs.randn(rows, d), t=t,
                ck=rs.randn(n_layers, bsz, slots, d),
                cv=rs.randn(n_layers, bsz, slots, d), mask=mask,
                kc=rs.randn(rows, n_layers, n_t, d),
                vc=rs.randn(rows, n_layers, n_t, d), anc=anc)


def _port(a, mix, device="cpu"):
    """The inputs as port tensors of the mixture's types."""
    tx, tw, tc, tm = (BF16 if m == "bf16" else F32 for m in mix)

    def t(v, dt):
        return torch.from_numpy(np.asarray(v, np.float32)).to(device, dt)

    return dict(x=t(a["x"], tx), t=torch.from_numpy(a["t"]).to(device),
                ck=t(a["ck"], tm), cv=t(a["cv"], tm),
                mask=torch.from_numpy(a["mask"]).to(device),
                kc=t(a["kc"], tc), vc=t(a["vc"], tc),
                w={k: t(v, tw) for k, v in a["w"].items()},
                anc=None if a["anc"] is None
                else torch.from_numpy(a["anc"]).to(device))


def test_cpu_bf16_is_plain_and_counts_nothing():
    a = _port(_inputs(np.random.RandomState(5), 2, 3, 2, 6, 5, 16, 24,
                      True), ("bf16",) * 4)
    names = ("stack_launches", "layer_launches", "bf16_stack_launches",
             "bf16_layer_launches", "tc_stack_launches", "tc_layer_launches")
    before = [getattr(tdk, n) for n in names]
    args = (a["x"], a["t"], a["ck"], a["cv"], a["mask"])
    got = tdk.decoder_stack_step(*args, a["kc"].clone(), a["vc"].clone(),
                                 a["w"], a["anc"], n_heads=4, want_attn=True)
    want = tdo.decoder_stack_step_plain(*args, a["kc"].clone(),
                                        a["vc"].clone(), a["w"], a["anc"],
                                        n_heads=4, want_attn=True)
    w0 = {k: v[0] for k, v in a["w"].items()}
    largs = (a["x"], a["t"], a["ck"][0], a["cv"][0], a["mask"])
    got_l = tdk.decoder_layer_step(*largs, a["kc"][:, 0].clone(),
                                   a["vc"][:, 0].clone(), w0, n_heads=4)
    want_l = tdo.decoder_layer_step_plain(*largs, a["kc"][:, 0].clone(),
                                          a["vc"][:, 0].clone(), w0,
                                          n_heads=4)
    assert [getattr(tdk, n) for n in names] == before
    for g, w in zip(tuple(got) + tuple(got_l), tuple(want) + tuple(want_l)):
        assert g.dtype == w.dtype and torch.equal(g, w)


def _close_scaled(got, want, what):
    """max|got - want| <= TOL * max(1, max|want|), one tensor."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= TOL * max(1.0, np.abs(want).max()), (what, err)


def _jax(v, dt):
    import jax.numpy as jnp
    import ml_dtypes

    v = np.asarray(v, np.float32)
    return jnp.asarray(v.astype(ml_dtypes.bfloat16) if dt == "bf16" else v)


# the caption path's cache and slots, 2 images of 3 beams, 2 layers, d 32
B, KB, L, T, S, D, DFF, H = 2, 3, 2, 16, 196, 32, 48, 4


@pytest.mark.parametrize("mix", tdk.MIXTURES[1:], ids="/".join)
def test_plain_stack_matches_jax_lazy_with_attn(mix):
    """The bf16 plain stack with the lazy cache and want_attn: every operand
    bf16 against the Pallas stack kernel in interpret mode; f32 x and
    weights over bf16 caches and memory against `_layer_math` layer by
    layer, the step's own k_t / v_t cast to the caches' type after each
    layer (JAX attends over their f32 values, the plain version reads them
    back from the bf16 cache, as JAX's own XLA decode step does)."""
    import jax.numpy as jnp

    from unpaired_image_captioning_tpu.ops import transformer_decode as jtd

    a = _inputs(np.random.RandomState(25), B, KB, L, T, S, D, DFF, True)
    mx, mw, mc, mm = mix
    p = _port(a, mix)
    got = tdk.decoder_stack_step(p["x"], p["t"], p["ck"], p["cv"], p["mask"],
                                 p["kc"].clone(), p["vc"].clone(), p["w"],
                                 p["anc"], n_heads=H, want_attn=True)
    t = jnp.asarray(a["t"])
    if mx == mc:
        jw = {k: _jax(v[:, None].repeat(8, 1) if v.ndim == 2 else v, mw)
              for k, v in a["w"].items()}
        want = jtd.decoder_stack_step(
            _jax(a["x"], mx), t, _jax(a["ck"], mm), _jax(a["cv"], mm),
            jnp.asarray(a["mask"]), _jax(a["kc"], mc), _jax(a["vc"], mc), jw,
            jnp.asarray(a["anc"]), n_heads=H, interpret=True, want_attn=True)
    else:
        x = _jax(a["x"], mx)
        ks, vs = [], []
        for li in range(L):
            jw = {k: _jax(v[li][None] if v.ndim == 2 else v[li], mw)
                  for k, v in a["w"].items()}
            kc, vc = _jax(a["kc"][:, li], mc), _jax(a["vc"][:, li], mc)
            x, kc2, vc2, attn, *_ = jtd._layer_math(
                x, t[:, None], _jax(a["ck"][li], mm), _jax(a["cv"][li], mm),
                jnp.asarray(a["mask"]), kc, vc, jw, n_heads=H, bi=B, kb=KB,
                anc=jnp.asarray(a["anc"]).reshape(B, KB, T))
            ks.append(kc2.astype(kc.dtype))
            vs.append(vc2.astype(vc.dtype))
        want = (x, jnp.stack(ks, 1), jnp.stack(vs, 1),
                attn.reshape(B * KB, S))
    assert len(got) == len(want) == 4
    for name, g, w in zip(("x", "cache_k", "cache_v", "attn"), got, want):
        assert str(g.dtype).endswith(str(w.dtype)), (name, g.dtype, w.dtype)
        _close_scaled(g.float().numpy(), np.asarray(w, np.float32), name)


@pytest.mark.parametrize("mix", tdk.MIXTURES[1:], ids="/".join)
def test_plain_layer_matches_jax(mix):
    """The bf16 plain layer at the path's T and S against JAX's
    `decoder_layer_step` in interpret mode (every operand bf16) or its math
    (f32 x and weights over bf16 caches and memory)."""
    import jax.numpy as jnp

    from unpaired_image_captioning_tpu.ops import transformer_decode as jtd

    a = _inputs(np.random.RandomState(26), B, KB, 1, T, S, D, DFF, False)
    mx, mw, mc, mm = mix
    p = _port(a, mix)
    w0 = {k: v[0] for k, v in p["w"].items()}
    got = tdk.decoder_layer_step(p["x"], p["t"], p["ck"][0], p["cv"][0],
                                 p["mask"], p["kc"][:, 0].clone(),
                                 p["vc"][:, 0].clone(), w0, n_heads=H)
    jw = {k: _jax(v[0][None] if v.ndim == 2 else v[0], mw)
          for k, v in a["w"].items()}
    args = (_jax(a["x"], mx), jnp.asarray(a["t"]), _jax(a["ck"][0], mm),
            _jax(a["cv"][0], mm), jnp.asarray(a["mask"]),
            _jax(a["kc"][:, 0], mc), _jax(a["vc"][:, 0], mc), jw)
    if mx == mc:
        want = jtd.decoder_layer_step(*args, n_heads=H, interpret=True)
    else:
        x, kc, vc, *_ = jtd._layer_math(
            args[0], args[1][:, None], *args[2:], n_heads=H, bi=B, kb=KB)
        want = (x, kc.astype(args[5].dtype), vc.astype(args[6].dtype))
    for name, g, w in zip(("x", "cache_k", "cache_v"), got, want):
        assert str(g.dtype).endswith(str(w.dtype)), (name, g.dtype, w.dtype)
        _close_scaled(g.float().numpy(), np.asarray(w, np.float32), name)


# ---------------------------------------------------------------------------
# on a card


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _scaled(name, got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape, (name, i)
        g, w = g.float(), w.float()
        err = (g - w).abs().max().item()
        assert err <= TOL * max(1.0, w.abs().max().item()), (name, i, err)


_MIX = {"serve": ("f32", "f32", "bf16", "bf16"), "all_bf16": ("bf16",) * 4,
        "x_bf16": ("bf16", "f32", "bf16", "bf16"),
        "xw_bf16": ("bf16", "bf16", "f32", "f32")}
_FL = {"serve": SERVE, "all_bf16": ALL_BF16, "x_bf16": X_BF16,
       "xw_bf16": XW_BF16}
# (B, kb, T, S, d, d_ff, heads, lazy): the path's shapes and the tiling's
# edges: rows not a multiple of 64, S not a multiple of the slot split, one
# beam, 32 beams (two query groups), head widths 32, 96, 256 and 512, a
# slice that fits a block only as bf16, d_ff off 8 (products off the
# tensor cores), a head width of 4 (8-byte loads)
CASES = {
    "caption": (50, 5, 16, 196, 512, 512, 8, False),
    "batch50": (50, 1, 16, 196, 512, 512, 8, False),
    "nmt": (50, 15, 20, 16, 512, 2048, 8, True),
    "rows7x3": (7, 3, 16, 196, 512, 512, 8, False),
    "slots197": (4, 5, 16, 197, 512, 512, 8, True),
    "dh32": (4, 5, 16, 196, 512, 512, 16, False),
    "dh96": (4, 5, 16, 196, 768, 768, 8, False),
    "dh256_beam32": (2, 32, 16, 196, 512, 512, 2, True),
    "dh512_S64": (4, 5, 16, 64, 512, 512, 1, False),
    "dff510": (4, 5, 16, 196, 512, 510, 8, False),
    "dh4": (3, 2, 7, 5, 20, 40, 5, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("mix", list(_MIX))
@pytest.mark.parametrize("case", list(CASES))
def test_cuda_typed_step_matches_plain(cuda_dev, case, mix):
    """Stack (2 layers, want_attn where lazy) and layer against the plain
    versions within 1e-2 of each output's scale; each call's route is the
    rule's (the wrapper raises otherwise) and counted on the tensor cores
    where the rule says so."""
    bsz, kb, n_t, slots, d, dff, heads, lazy = CASES[case]
    rs = np.random.RandomState(sum(CASES[case][:7]))
    p = _port(_inputs(rs, bsz, kb, 2, n_t, slots, d, dff, lazy), _MIX[mix],
              cuda_dev)
    tc = bool(tdk.route(_FL[mix], d, dff, heads, n_t, slots)
              & tdk.ROUTE_TC)
    before = (tdk.tc_stack_launches, tdk.tc_layer_launches)
    args = (p["x"], p["t"], p["ck"], p["cv"], p["mask"])
    got = tdk.decoder_stack_step(*args, p["kc"].clone(), p["vc"].clone(),
                                 p["w"], p["anc"], n_heads=heads,
                                 want_attn=lazy)
    want = tdo.decoder_stack_step_plain(*args, p["kc"].clone(),
                                        p["vc"].clone(), p["w"], p["anc"],
                                        n_heads=heads, want_attn=lazy)
    torch.cuda.synchronize()
    _scaled(f"{case} {mix} stack", got, want)
    if lazy:
        again = tdk.decoder_stack_step(*args, p["kc"].clone(),
                                       p["vc"].clone(), p["w"], p["anc"],
                                       n_heads=heads, want_attn=True)
        torch.cuda.synchronize()
        assert all(torch.equal(g, h) for g, h in zip(got, again)), case
    w0 = {k: v[0].contiguous() for k, v in p["w"].items()}
    largs = (p["x"], p["t"], p["ck"][0].contiguous(),
             p["cv"][0].contiguous(), p["mask"],
             p["kc"][:, 0].contiguous(), p["vc"][:, 0].contiguous(), w0)
    got = tdk.decoder_layer_step(*[v.clone() if torch.is_tensor(v) else v
                                   for v in largs], n_heads=heads)
    want = tdo.decoder_layer_step_plain(*[v.clone() if torch.is_tensor(v)
                                          else v for v in largs],
                                        n_heads=heads)
    torch.cuda.synchronize()
    _scaled(f"{case} {mix} layer", got, want)
    stacks = 2 if lazy else 1
    assert (tdk.tc_stack_launches - before[0],
            tdk.tc_layer_launches - before[1]) == (stacks * tc, tc)


@pytest.mark.cuda
def test_cuda_route_runs_its_kernels(cuda_dev):
    """The all-bf16 step at the caption shape runs the tensor-core GEMM and
    the fast attentions' typed instances, and none of the scalar ones; the
    serving mixture the f32 FMA GEMM beside the same attentions (the
    profiler may lose a session's first events, never invent one)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    bsz, kb, n_t, slots, d, dff, heads, _ = CASES["caption"]
    for mix in ("all_bf16", "serve"):
        p = _port(_inputs(np.random.RandomState(3), bsz, kb, 1, n_t, slots,
                          d, dff, False), _MIX[mix], cuda_dev)

        def run():
            return tdk.decoder_stack_step(
                p["x"], p["t"], p["ck"], p["cv"], p["mask"], p["kc"],
                p["vc"], p["w"], n_heads=heads)

        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        names = {e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA}
        scalar = {n for n in names if "_chunked" in n or "_wide" in n
                  or "_pieces" in n}
        assert not scalar, (mix, names)
        tc = {n for n in names if "decode_gemm_bf16_kernel" in n}
        fma = {n for n in names if "decode_gemm_kernel" in n}
        if mix == "all_bf16":
            assert not fma, names
        else:
            assert not tc, names
