"""B5's tensor-core instance (`csrc/mha_train_tc.cuh`): the training
attention's all-bf16 calls on `mma.sync` bf16 products with f32 sums.

On the CPU: the routing rule (`kernels/mha_train.py::tensor_core`: which
dtype and head width reach the tensor cores, the same rule inside the
whole layers), that a CPU tensor takes the plain version and counts no
launch, and the bf16 plain forward and backward against JAX's
`fused_mha_train(..., interpret=True)` at the path's shapes: T 17 over S
196 and T = S = 196, 8 heads of dh 16, dropout 0 and 0.1, both mask shapes
and a fully masked row (`tests/test_torch_dtype_transformer.py` holds the
same plain versions at T 8 / 12 over S 12 and 8, dh 8, rates 0 and 0.3;
none of the cases here repeats one of those). Tolerance rtol = atol =
1e-2, as that file's.

On a card: the instance against its plain version at ragged shapes (T 17,
196 and 65; S 17, 196 and 1; dh 32, 64, 96 (padded in bucket 128), 128
and 256; a [B, 1, S] padding mask with a fully masked element, a [B, T, S]
mask with a fully masked row, and a causal one; rate 0 and 0.1), within
1e-2 of each tensor's scale; the backward bit for bit on a rerun; the
`tc_*_launches` counts; and the CUDA kernels each route runs, read from
the profiler (the counters state the rule, the kernel names show it ran).
Card tests carry the `cuda` marker and skip without a card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_mha_tc.py
"""

import numpy as np
import pytest
import torch

from unpaired_image_captioning_tpu_torch.kernels import layer_train as ltk
from unpaired_image_captioning_tpu_torch.kernels import mha_train as mhk
from unpaired_image_captioning_tpu_torch.ops import mha_train as mho

F32, BF16 = torch.float32, torch.bfloat16
TOL = 1e-2
SEED = 4321
_COUNTERS = ("fwd_launches", "bwd_launches", "bf16_fwd_launches",
             "bf16_bwd_launches", "tc_fwd_launches", "tc_bwd_launches")


def _counts():
    return [getattr(mhk, c) for c in _COUNTERS]


@pytest.mark.parametrize("dtype,dh,tc", [
    (BF16, 64, True),     # the paths' heads
    (BF16, 96, True),     # padded in bucket 128
    (BF16, 8, True), (BF16, 16, True), (BF16, 32, True), (BF16, 128, True),
    (BF16, 256, True),
    (BF16, 6, False),     # rows off 16 bytes: the ODD instance
    (BF16, 50, False),
    (BF16, 4, False),
    (BF16, 384, False),   # past 256: the column-chunked kernels
    (BF16, 264, False),
    (F32, 64, False),     # f32 multiplies in f32, as in JAX
    (F32, 96, False),
])
def test_routing_rule(dtype, dh, tc):
    assert mhk.tensor_core(dtype, dh) is tc
    assert ltk.attn_tensor_core is mhk.tensor_core


def _inputs(rs, b, t, s, d, kind, device="cpu"):
    """q, k, v, g [b, t|s, d] and maskadd: 'pad' [b, 1, s] with element 1
    fully masked, 'rows' [b, t, s] with row t // 2 of element 0 fully
    masked, 'causal' [b, t, s] keeping keys <= the row."""
    q, g = rs.randn(b, t, d), rs.randn(b, t, d)
    k, v = rs.randn(b, s, d), rs.randn(b, s, d)
    if kind == "pad":
        keep = rs.rand(b, 1, s) > 0.2
        keep[:, :, 0] = True
        keep[1] = False
    elif kind == "rows":
        keep = rs.rand(b, t, s) > 0.3
        keep[0, t // 2] = False
    else:
        keep = np.tril(np.ones((t, s), bool))[None].repeat(b, 0)
    maskadd = np.where(keep, 0.0, -1e9).astype(np.float32)
    as_t = (lambda a: torch.from_numpy(a.astype(np.float32)).to(device, BF16))
    return (as_t(q), as_t(k), as_t(v), as_t(g),
            torch.from_numpy(maskadd).to(device))


def test_cpu_bf16_is_plain_and_counts_nothing():
    rs = np.random.RandomState(3)
    q, k, v, g, maskadd = _inputs(rs, 2, 9, 11, 64, "pad")
    seed = torch.tensor([SEED], dtype=torch.int32)
    kw = dict(n_heads=2, rate=0.1)
    before = _counts()
    out, stats = mhk.mha_train_fwd(q, k, v, maskadd, seed, **kw)
    grads = mhk.mha_train_bwd(q, k, v, maskadd, seed, g, out, stats, **kw)
    assert _counts() == before
    assert torch.equal(out, mho.mha_train_plain(q, k, v, maskadd, seed, **kw))
    assert torch.equal(stats, mho.softmax_stats(q, k, maskadd, n_heads=2))
    for a, c in zip(grads, mho.mha_train_plain_bwd(q, k, v, maskadd, seed, g,
                                                   **kw)):
        assert a.dtype == BF16 and torch.equal(a, c)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("kind", ["pad", "rows"])
@pytest.mark.parametrize("t,s", [(17, 196), (196, 196)])
def test_plain_bf16_matches_pallas_at_path_shapes(t, s, kind, rate):
    """The bf16 plain forward and backward (what the instance is held
    against on the card) against the Pallas kernel in interpret mode: 8
    heads of dh 16 over the path's query and key counts."""
    import jax
    import jax.numpy as jnp
    import ml_dtypes

    from unpaired_image_captioning_tpu.ops.mha_train import fused_mha_train

    b, heads, d = 2, 8, 128
    rs = np.random.RandomState(t + s + (kind == "rows"))
    q, k, v, g, maskadd = _inputs(rs, b, t, s, d, kind)
    seed = np.asarray([SEED], np.int32)

    def j(x):
        return jnp.asarray(x.float().numpy().astype(ml_dtypes.bfloat16))

    out, vjp = jax.vjp(
        lambda a, b_, c: fused_mha_train(a, b_, c, jnp.asarray(maskadd),
                                         jnp.asarray(seed), heads, rate,
                                         True), j(q), j(k), j(v))
    want = (out,) + vjp(j(g))
    ts = torch.from_numpy(seed)
    kw = dict(n_heads=heads, rate=rate)
    got = (mho.mha_train_plain(q, k, v, maskadd, ts, **kw),) + \
        mho.mha_train_plain_bwd(q, k, v, maskadd, ts, g, **kw)
    for name, a, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert a.dtype == BF16, name
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(w, np.float32), rtol=TOL,
                                   atol=TOL, err_msg=name)


# ---------------------------------------------------------------------------
# on a card


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _scaled_close(name, got, want):
    for i, (a, c) in enumerate(zip(got, want)):
        assert a.dtype == c.dtype and a.shape == c.shape, (name, i)
        a, c = a.float(), c.float()
        err = (a - c).abs().max().item() if c.numel() else 0.0
        assert err <= TOL * max(1.0, c.abs().max().item()), (name, i, err)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("kind", ["pad", "rows", "causal"])
@pytest.mark.parametrize("dh", [32, 64, 96, 128, 256])
@pytest.mark.parametrize("t,s", [(17, 196), (196, 196), (65, 17), (17, 17),
                                 (65, 1), (196, 1)])
def test_cuda_tc_matches_plain(cuda_dev, t, s, dh, kind, rate):
    heads = 2
    rs = np.random.RandomState(t * 7 + s + dh)
    q, k, v, g, maskadd = _inputs(rs, 2, t, s, heads * dh, kind, cuda_dev)
    seed = torch.tensor([SEED], dtype=torch.int32, device=cuda_dev)
    kw = dict(n_heads=heads, rate=rate)
    before = _counts()
    out, stats = mhk.mha_train_fwd(q, k, v, maskadd, seed, **kw)
    grads = mhk.mha_train_bwd(q, k, v, maskadd, seed, g, out, stats, **kw)
    again = mhk.mha_train_bwd(q, k, v, maskadd, seed, g, out, stats, **kw)
    out2, stats2 = mhk.mha_train_fwd(q, k, v, maskadd, seed, **kw)
    want = (mho.mha_train_plain(q, k, v, maskadd, seed, **kw),
            mho.softmax_stats(q, k, maskadd, n_heads=heads))
    want_g = mho.mha_train_plain_bwd(q, k, v, maskadd, seed, g, **kw)
    torch.cuda.synchronize()
    name = f"T {t} S {s} dh {dh} {kind} rate {rate}"
    assert [c - b for c, b in zip(_counts(), before)] == [2, 2, 2, 2, 2, 2]
    # the statistics too: a score sum in another order may round to the
    # neighbouring bf16 before the division, and so move a row's max
    _scaled_close(name, (out, stats) + grads, want + want_g)
    assert torch.equal(out, out2) and torch.equal(stats, stats2), name
    assert all(torch.equal(a, c) for a, c in zip(grads, again)), name


def _kernel_names(fn):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.name for e in prof.events() if e.device_type == DeviceType.CUDA}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d,heads", [
    (BF16, 512, 8),    # dh 64: the tensor cores
    (BF16, 192, 2),    # dh 96: padded in bucket 128
    (BF16, 100, 2),    # dh 50: rows off 16 bytes, the FMA core's ODD instance
    (BF16, 384, 1),    # dh 384: the FMA core's column chunks
    (F32, 512, 8),     # f32: the FMA core
])
def test_cuda_route_runs_its_kernels(cuda_dev, dtype, d, heads):
    """The counters follow `tensor_core`, and the kernels the profiler sees
    are the tensor-core instance's exactly when it says so."""
    rs = np.random.RandomState(d)
    q, k, v, g, maskadd = _inputs(rs, 2, 19, 23, d, "pad", cuda_dev)
    q, k, v, g = (x.to(dtype) for x in (q, k, v, g))
    seed = torch.tensor([SEED], dtype=torch.int32, device=cuda_dev)
    kw = dict(n_heads=heads, rate=0.1)
    tc = mhk.tensor_core(dtype, d // heads)
    out, stats = mhk.mha_train_fwd(q, k, v, maskadd, seed, **kw)
    before = _counts()
    names = _kernel_names(lambda: (
        mhk.mha_train_fwd(q, k, v, maskadd, seed, **kw),
        mhk.mha_train_bwd(q, k, v, maskadd, seed, g, out, stats, **kw)))
    got = [c - b for c, b in zip(_counts(), before)]
    bf = int(dtype == BF16)
    assert got == [2, 2, 2 * bf, 2 * bf, 2 * tc, 2 * tc]
    # the profiler may lose a session's first events, never invent one
    tc_names = {n for n in names if "_tc_kernel" in n}
    fma_names = {n for n in names if "mha_" in n} - tc_names
    assert bool(tc_names) == tc and not (tc and fma_names), names


@pytest.mark.cuda
@pytest.mark.parametrize("d,heads,tc", [(64, 2, True), (40, 5, True),
                                        (100, 2, False)])
def test_cuda_layers_attend_on_the_rule(cuda_dev, d, heads, tc):
    """B6 and B7 bf16 calls count their attention calls on B5's tensor
    cores under B5's rule (dh 32 and 8 do, dh 50 does not)."""
    from unpaired_image_captioning_tpu_torch.ops import layer_train as lto

    b, t, s, f = 2, 13, 21, 2 * d
    gen = torch.Generator(device=cuda_dev).manual_seed(d)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=cuda_dev)
                * scale).to(BF16)

    shapes = {"wqkv": (d, 3 * d), "bqkv": (3 * d,), "wo": (d, d),
              "wq": (d, d), "wo2": (d, d), "w1": (d, f), "b1": (f,),
              "w2": (f, d)}
    w = {k_: rnd(*shapes.get(k_, (d,)), scale=d ** -0.5)
         for k_ in set(lto.ENC_WEIGHTS) | set(lto.DEC_WEIGHTS)}
    x, g = rnd(b, t, d), rnd(b, t, d)
    mk, mv = rnd(b, s, d), rnd(b, s, d)
    pad = torch.zeros((b, 1, t), device=cuda_dev)
    pos = torch.arange(t, device=cuda_dev)
    tm = torch.where((pos[None, :] <= pos[:, None])[None].expand(b, t, t),
                     0.0, -1e9).contiguous()
    sm = torch.zeros((b, 1, s), device=cuda_dev)
    seed = torch.tensor([SEED], dtype=torch.int32, device=cuda_dev)
    seeds = torch.tensor([SEED, SEED ^ 0x55555555], dtype=torch.int32,
                         device=cuda_dev)
    kw = dict(n_heads=heads, rate=0.1)
    before = (ltk.tc_attn_fwd_launches, ltk.tc_attn_bwd_launches)
    ew = {k_: w[k_] for k_ in lto.ENC_WEIGHTS}
    dw = {k_: w[k_] for k_ in lto.DEC_WEIGHTS}
    _, saved = ltk.enc_layer_fwd(x, pad, seed, ew, **kw)
    ltk.enc_layer_bwd(x, pad, seed, ew, saved, g, **kw)
    _, saved = ltk.dec_layer_fwd(x, mk, mv, tm, sm, seeds, dw, **kw)
    ltk.dec_layer_bwd(x, mk, mv, tm, sm, seeds, dw, saved, g, **kw)
    torch.cuda.synchronize()
    assert (ltk.tc_attn_fwd_launches - before[0],
            ltk.tc_attn_bwd_launches - before[1]) == ((3, 3) if tc
                                                      else (0, 0))
