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
