"""The port's training LayerNorm (`kernels/ln_train.py`, plain version in
`ops/ln_train.py`) against the Pallas `fused_layer_norm` in interpret mode:
the output and the `jax.vjp` gradients (dx, d_scale, d_offset summed over
every row), at 1e-5 (f32 sums in another order).

Card tests carry the `cuda` marker and skip without a card. On a card
machine without jax, run them with

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_ln_train.py
"""

import numpy as np
import pytest
import torch

from unpaired_image_captioning_tpu_torch.kernels import ln_train as lk
from unpaired_image_captioning_tpu_torch.ops import ln_train as lo

TOL = 1e-5


@pytest.mark.parametrize("b,t,d", [(3, 20, 128), (2, 17, 256), (2, 3, 6),
                                   (3, 2, 130), (2, 2, 4100)])
def test_matches_pallas_interpret(b, t, d):
    import jax
    import jax.numpy as jnp

    from unpaired_image_captioning_tpu.ops.ln_train import fused_layer_norm

    rs = np.random.RandomState(b + t)
    x = (rs.randn(b, t, d) * 3.0 + 1.0).astype(np.float32)
    scale = rs.randn(d).astype(np.float32)
    offset = rs.randn(d).astype(np.float32)
    g = rs.randn(b, t, d).astype(np.float32)

    jy, vjp = jax.vjp(lambda x_, s_, o_: fused_layer_norm(x_, s_, o_, 1e-6,
                                                          True),
                      jnp.asarray(x), jnp.asarray(scale), jnp.asarray(offset))
    jdx, jds, jdo = vjp(jnp.asarray(g))

    tx, ts, to = (torch.tensor(a, requires_grad=True)
                  for a in (x, scale, offset))
    y = lk.layer_norm_train(tx, ts, to, 1e-6)
    y.backward(torch.from_numpy(g))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=TOL,
                               atol=TOL)
    for got, want in ((tx.grad, jdx), (ts.grad, jds), (to.grad, jdo)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL * 10)


def test_plain_backward_matches_autograd():
    rs = np.random.RandomState(5)
    x = torch.tensor(rs.randn(4, 6, 16) * 2.0, requires_grad=True)
    scale = torch.tensor(rs.randn(16), requires_grad=True)
    offset = torch.tensor(rs.randn(16), requires_grad=True)
    g = torch.tensor(rs.randn(4, 6, 16))
    lo.ln_train_plain(x, scale, offset).backward(g)
    dx, ds, db = lo.ln_train_plain_bwd(x.detach(), scale.detach(), g)
    for got, want in ((dx, x.grad), (ds, scale.grad), (db, offset.grad)):
        torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("d", [4096, 8192])
def test_shape_check_takes_any_width(d):
    """The wrappers' shape check takes rows of any width from 2 (the
    backward kept a per-warp accumulator of the row in shared memory and
    refused d past 3,632 before); d = 1 has no unbiased variance."""
    x, scale = torch.zeros((3, d)), torch.zeros((d,))
    arrays = {"x": (x, x.shape), "scale": (scale, (d,)), "g": (x, x.shape)}
    lk._check("ln_train_bwd", arrays, d, x.device)
    with pytest.raises(ValueError, match="width 1"):
        lk._check("ln_train_bwd", {"x": (x[:, :1], (3, 1))}, 1, x.device)


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,d", [(50, 196, 512), (50, 17, 512),
                                   (3, 5, 100)])
def test_cuda_ln_train_matches_plain(cuda_dev, b, t, d):
    gen = torch.Generator(device=cuda_dev).manual_seed(t)
    x = torch.randn((b, t, d), generator=gen, device=cuda_dev) * 3 + 1
    scale = torch.randn((d,), generator=gen, device=cuda_dev)
    offset = torch.randn((d,), generator=gen, device=cuda_dev)
    g = torch.randn((b, t, d), generator=gen, device=cuda_dev)
    y = lk.ln_train_fwd(x, scale, offset)
    grads = lk.ln_train_bwd(x, scale, g)
    again = lk.ln_train_bwd(x, scale, g)
    refs = (lo.ln_train_plain(x, scale, offset),) + lo.ln_train_plain_bwd(
        x, scale, g)
    torch.cuda.synchronize()
    for got, want in zip((y,) + grads, refs):
        tol = 1e-4 * max(1.0, want.abs().max().item())
        assert (got - want).abs().max().item() <= tol
    for a, c in zip(grads, again):
        assert torch.equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 7, 9800])
@pytest.mark.parametrize("d", [6, 100, 510, 768, 1024, 1030, 4096, 6000])
def test_cuda_ln_train_any_width(cuda_dev, rows, d):
    """Forward and backward against plain at widths of every instance: the
    register kernels (d a multiple of 4 up to 1,024), the general one (off
    16 bytes, past 1,024), one row to more than a block a SM; the backward
    twice, bit for bit (the partial sums in a fixed order)."""
    gen = torch.Generator(device=cuda_dev).manual_seed(rows + d)
    x = torch.randn((rows, d), generator=gen, device=cuda_dev) * 3 + 1
    scale = torch.randn((d,), generator=gen, device=cuda_dev)
    offset = torch.randn((d,), generator=gen, device=cuda_dev)
    g = torch.randn((rows, d), generator=gen, device=cuda_dev)
    y = lk.ln_train_fwd(x, scale, offset)
    grads = lk.ln_train_bwd(x, scale, g)
    again = lk.ln_train_bwd(x, scale, g)
    refs = (lo.ln_train_plain(x, scale, offset),) + lo.ln_train_plain_bwd(
        x, scale, g)
    torch.cuda.synchronize()
    for got, want in zip((y,) + grads, refs):
        tol = 1e-4 * max(1.0, want.abs().max().item())
        assert (got - want).abs().max().item() <= tol
    for a, c in zip(grads, again):
        assert torch.equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("mix", [("bf16", "bf16"), ("bf16", "f32")],
                         ids="/".join)
@pytest.mark.parametrize("b,t,d", [(50, 196, 512), (50, 17, 512),
                                   (3, 5, 100)])
def test_cuda_ln_train_bf16_matches_plain(cuda_dev, b, t, d, mix):
    """The bf16 entries (x and g bf16, scale / offset bf16 or f32) against
    the plain version at rtol = atol = 1e-2: y and dx in x's type,
    d_scale / d_offset in scale's; a bf16 launch each way."""
    tx, tp = (torch.bfloat16 if m == "bf16" else torch.float32 for m in mix)
    gen = torch.Generator(device=cuda_dev).manual_seed(t)
    x = (torch.randn((b, t, d), generator=gen, device=cuda_dev) * 3 + 1
         ).to(tx)
    scale = torch.randn((d,), generator=gen, device=cuda_dev).to(tp)
    offset = torch.randn((d,), generator=gen, device=cuda_dev).to(tp)
    g = torch.randn((b, t, d), generator=gen, device=cuda_dev).to(tx)
    before = (lk.bf16_fwd_launches, lk.bf16_bwd_launches)
    y = lk.ln_train_fwd(x, scale, offset)
    grads = lk.ln_train_bwd(x, scale, g)
    refs = (lo.ln_train_plain(x, scale, offset),) + lo.ln_train_plain_bwd(
        x, scale, g)
    torch.cuda.synchronize()
    assert (lk.bf16_fwd_launches, lk.bf16_bwd_launches) == (before[0] + 1,
                                                            before[1] + 1)
    for got, want in zip((y,) + grads, refs):
        assert got.dtype == want.dtype
        torch.testing.assert_close(got.float(), want.float(), rtol=1e-2,
                                   atol=1e-2 * max(1.0, want.abs().max()
                                                   .item()))


# The typed register-row instances (csrc/ln_train.cu, since the bf16
# redesign): the routing rule on the CPU, the instances on the card.
BF, F32 = torch.bfloat16, torch.float32
# (x, scale / offset) of the standalone wrappers' typed mixtures: the cast
# route, JAX's default config's bf16 x over f32 parameters, f32 x over a
# bf16 copy of the parameters
WRAPPER_MIXES = {"bf16/bf16": (BF, BF), "bf16/f32": (BF, F32),
                 "f32/bf16": (F32, BF)}
# B6 / B7's bf16 calls (csrc/layer_train.cu ln_bwd_fl): x, the parameters,
# y / dx, the residual and d_scale / d_offset bf16, dy f32, rounded
B6_FLAGS = (lk.LN_RND | lk.LN_X_BF | lk.LN_P_BF | lk.LN_Y_BF | lk.LN_R_BF
            | lk.LN_D_BF)


def _wrapper_flags(mix):
    tx, tp = WRAPPER_MIXES[mix]
    x, p = torch.zeros(0, dtype=tx), torch.zeros(0, dtype=tp)
    return lk.mixture("test", x, p, p, x)


@pytest.mark.parametrize("aligned", [True, False], ids=["aligned",
                                                        "unaligned"])
@pytest.mark.parametrize("mix", list(WRAPPER_MIXES) + ["b6", "f32"])
@pytest.mark.parametrize("d", [8, 100, 512, 768, 1024, 1030, 2048])
def test_register_instance_rule(d, mix, aligned):
    """`register_instance`: every mixture with a bf16 x (the cast route,
    bf16 x over f32 parameters, B6 / B7's) at d a multiple of 8 up to 1,024
    on 16-byte pointers runs the register instances; other widths,
    unaligned pointers, an f32 x and all-f32 calls do not."""
    if mix == "f32":
        flags, res = 0, False
    elif mix == "b6":
        flags, res = B6_FLAGS, True
    else:
        flags, res = _wrapper_flags(mix), False
    want = (mix not in ("f32", "f32/bf16") and d % 8 == 0 and d <= 1024
            and aligned)
    assert lk.register_instance(d, flags, aligned, res=res) is want


@pytest.mark.parametrize("flags,res", [
    (lk.LN_X_BF | lk.LN_G_BF | lk.LN_RND, False),        # y f32, x bf16
    (lk.LN_P_BF | lk.LN_D_BF | lk.LN_G_BF, False),       # g bf16, x f32
    (B6_FLAGS & ~lk.LN_R_BF, True),                      # res f32, x bf16
    (lk.LN_P_BF | lk.LN_D_BF | lk.LN_R_BF, True),        # res bf16, x f32
    (lk.LN_X_BF | lk.LN_Y_BF | lk.LN_RND, False),        # g, params f32
    (lk.LN_RND, False)])                                 # every array f32
def test_register_instance_refuses_other_types(flags, res):
    """The instances compile x, y / dx and the residual bf16, and g or the
    parameters bf16; a call of any other types stays on the general typed
    instances, as does one with no bf16 operand."""
    assert lk.register_instance(512, flags, True, res=res) is False


@pytest.mark.parametrize("got,fl,d,reg", [
    (lk.ROUTE_ROWS, lk.LN_X_BF | lk.LN_Y_BF | lk.LN_G_BF, 512, True),
    (lk.ROUTE_TYPED, lk.LN_X_BF | lk.LN_Y_BF | lk.LN_G_BF, 100, False),
    (lk.ROUTE_F32, 0, 512, False),
    (lk.ROUTE_TYPED, lk.LN_X_BF | lk.LN_Y_BF | lk.LN_G_BF, 512, None),
    (lk.ROUTE_ROWS, lk.LN_X_BF | lk.LN_Y_BF | lk.LN_G_BF, 100, None),
    (lk.ROUTE_ROWS, 0, 512, None)])
def test_reported_route_is_held_against_the_rule(got, fl, d, reg):
    """The wrappers count a register-row launch from the route the C entry
    reports, and raise where that route is not the one the rule names
    (None: a mismatch)."""
    x = torch.zeros((2, d), dtype=BF if fl else F32)
    if reg is None:
        with pytest.raises(RuntimeError, match="ran route"):
            lk._ran("ln_train_fwd", got, d, fl, (x,))
    else:
        assert lk._ran("ln_train_fwd", got, d, fl, (x,)) is reg


def _bf16_inputs(dev, rows, d, mix, seed):
    tx, tp = WRAPPER_MIXES[mix]
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn((rows, d), generator=gen, device=dev) * 3 + 1).to(tx)
    scale = (1 + 0.1 * torch.randn((d,), generator=gen, device=dev)).to(tp)
    offset = (0.1 * torch.randn((d,), generator=gen, device=dev)).to(tp)
    g = torch.randn((rows, d), generator=gen, device=dev).to(tx)
    return x, scale, offset, g


def _held_bf16(got, want):
    """Each output in the plain version's type, |diff| <= 1e-2 + 1e-2 |plain|
    elementwise (chip_smoke.BF16_TOL)."""
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        torch.testing.assert_close(a.float(), b.float(), rtol=1e-2,
                                   atol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("mix", list(WRAPPER_MIXES))
@pytest.mark.parametrize("d", [8, 512, 768, 1024])
@pytest.mark.parametrize("rows", [1, 7, 850, 9800])
def test_cuda_register_instances_match_plain(cuda_dev, rows, d, mix):
    """The typed register-row instances (a bf16 x), forward and backward,
    against the plain versions at rtol = atol = 1e-2, one register launch
    each way; an f32 x over bf16 parameters stays on the general typed
    instances and is held the same."""
    x, scale, offset, g = _bf16_inputs(cuda_dev, rows, d, mix, rows + d)
    before = (lk.reg_bf16_fwd_launches, lk.reg_bf16_bwd_launches)
    y = lk.ln_train_fwd(x, scale, offset)
    grads = lk.ln_train_bwd(x, scale, g)
    refs = (lo.ln_train_plain(x, scale, offset),) + lo.ln_train_plain_bwd(
        x, scale, g)
    torch.cuda.synchronize()
    reg = int(x.dtype == BF)
    assert (lk.reg_bf16_fwd_launches, lk.reg_bf16_bwd_launches) == (
        before[0] + reg, before[1] + reg)
    _held_bf16((y,) + grads, refs)


@pytest.mark.cuda
@pytest.mark.parametrize("mix", ["bf16/bf16", "bf16/f32"])
@pytest.mark.parametrize("rows,d", [(9800, 512), (850, 512), (9800, 1024),
                                    (7, 768)])
def test_cuda_register_instance_reruns_bit_for_bit(cuda_dev, rows, d, mix):
    """d_scale and d_offset (and dx) of two runs of the register backward
    are the same bits: the blocks' partials are summed in a fixed order."""
    x, scale, _, g = _bf16_inputs(cuda_dev, rows, d, mix, 3 * rows + d)
    first = lk.ln_train_bwd(x, scale, g)
    again = lk.ln_train_bwd(x, scale, g)
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_unaligned_rows_take_the_general_instance(cuda_dev):
    """Rows off 16 bytes (a contiguous view 2 bytes into its storage) stay
    on the general typed instances and still match plain."""
    x0, scale, offset, g0 = _bf16_inputs(cuda_dev, 50 * 17 + 1, 512,
                                         "bf16/bf16", 11)
    x = x0.view(-1)[1:1 + 850 * 512].view(850, 512)
    g = g0.view(-1)[1:1 + 850 * 512].view(850, 512)
    before = (lk.reg_bf16_fwd_launches, lk.reg_bf16_bwd_launches,
              lk.bf16_fwd_launches, lk.bf16_bwd_launches)
    y = lk.ln_train_fwd(x, scale, offset)
    grads = lk.ln_train_bwd(x, scale, g)
    refs = (lo.ln_train_plain(x, scale, offset),) + lo.ln_train_plain_bwd(
        x, scale, g)
    torch.cuda.synchronize()
    assert (lk.reg_bf16_fwd_launches, lk.reg_bf16_bwd_launches,
            lk.bf16_fwd_launches, lk.bf16_bwd_launches) == (
        before[0], before[1], before[2] + 1, before[3] + 1)
    _held_bf16((y,) + grads, refs)


def _profiled_names(shape):
    """The CUDA kernels torch.profiler records for B8's bf16 forward and
    backward at `shape` and, at 196 slots, for B6's bf16 encoder layer (its
    LayerNorms' dy f32, their residual bf16): (standalone, B6 or None)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from unpaired_image_captioning_tpu_torch.kernels import layer_train as ltk
    from unpaired_image_captioning_tpu_torch.ops import layer_train as lto

    def names(fn):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return " ".join(e.name for e in prof.events()
                        if e.device_type == DeviceType.CUDA)

    dev = torch.device("cuda", 0)
    b, t, d = shape
    x, scale, offset, g = _bf16_inputs(dev, b * t, d, "bf16/bf16", t)
    alone = names(lambda: (lk.ln_train_fwd(x, scale, offset),
                           lk.ln_train_bwd(x, scale, g)))
    if t != 196:
        return alone, None
    gen = torch.Generator(device=dev).manual_seed(5)
    xl, gl = (torch.randn(shape, generator=gen, device=dev).to(BF)
              for _ in range(2))
    maskadd = torch.zeros((b, 1, t), device=dev)
    seed = torch.tensor([4321], dtype=torch.int32, device=dev)
    shapes = {"wqkv": (d, 3 * d), "bqkv": (3 * d,), "wo": (d, d),
              "w1": (d, d), "w2": (d, d)}
    w = {}
    for k in lto.ENC_WEIGHTS:
        r = torch.randn(shapes.get(k, (d,)), generator=gen, device=dev)
        w[k] = (1 + 0.1 * r if k in ("l1s", "l2s") else 0.05 * r).to(BF)
    kw = dict(n_heads=8, rate=0.1)
    _, saved = ltk.enc_layer_fwd(xl, maskadd, seed, w, **kw)
    return alone, names(lambda: (
        ltk.enc_layer_fwd(xl, maskadd, seed, w, **kw),
        ltk.enc_layer_bwd(xl, maskadd, seed, w, saved, gl, **kw)))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(50, 196, 512), (50, 17, 512)])
def test_cuda_profiler_names_the_register_kernels(cuda_dev, shape):
    """At the default bf16 route's shapes the profiler shows the register
    kernels, forward and backward, and neither general typed kernel; so
    does B6's bf16 layer. The profiles run in a process of their own: a
    process that has profiled many times loses device events of later
    profiles (PERF.md section 7), so this test adds none to the test
    process."""
    import multiprocessing

    with multiprocessing.get_context("spawn").Pool(1) as pool:
        alone, b6 = pool.apply(_profiled_names, (shape,))
    for names in (alone,) if b6 is None else (alone, b6):
        for kernel in ("ln_fwd_rows_typed_kernel", "ln_bwd_rows_typed_kernel"):
            assert kernel in names
        for kernel in ("ln_fwd_typed_kernel", "ln_bwd_any_kernel"):
            assert kernel not in names
