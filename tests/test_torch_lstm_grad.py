"""PyTorch port, the LSTM cell's gradient: `ops.rnn.lstm_step` is
differentiable in w, b, x, h and c, as the JAX package's custom VJP
(`_make_fused_cell_vjp`: the Pallas forward, here in interpret mode, and
autodiff of the reference formula) is. Same numpy inputs and cotangents
on both sides; gradients within 1e-5 (f32), at G = 4 and G = 5, with a
batch that is not a multiple of the Pallas block.

On a CUDA card (`cuda` marker, skipped without one) the kernel's outputs
carry a `grad_fn` and the gradients match plain autograd. On a card
machine without jax:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_lstm_grad.py
"""

import numpy as np
import pytest
import torch

from unpaired_image_captioning_tpu_torch.kernels import lstm_cell as lk
from unpaired_image_captioning_tpu_torch.ops import rnn as trnn

torch.set_num_threads(1)
TOL = 1e-5
B, D, H, BLOCK_B = 5, 12, 8, 4


def _inputs(seed, b, d, h, g):
    rs = np.random.RandomState(seed)
    scale = 1.0 / np.sqrt(h)
    w = rs.uniform(-scale, scale, (d + h, g * h)).astype(np.float32)
    bias = rs.uniform(-scale, scale, (g * h,)).astype(np.float32)
    x, h0, c0, gh, gc = (rs.randn(b, n).astype(np.float32)
                         for n in (d, h, h, h, h))
    return w, bias, x, h0, c0, gh, gc


def _jax_grads(maxout, w, bias, x, h0, c0, gh, gc):
    import jax
    import jax.numpy as jnp

    from unpaired_image_captioning_tpu.ops.rnn import _make_fused_cell_vjp

    cell = _make_fused_cell_vjp(maxout, BLOCK_B, True)

    def loss(*args):
        hn, cn = cell(*args)
        return jnp.sum(hn * gh) + jnp.sum(cn * gc)

    return jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in (w, bias, x, h0, c0)))


def _torch_grads(maxout, w, bias, x, h0, c0, gh, gc):
    cell = trnn.init_lstm_params(D, H, maxout=maxout)
    with torch.no_grad():
        cell.w.copy_(torch.from_numpy(w))
        cell.b.copy_(torch.from_numpy(bias))
    xs = [torch.tensor(a, requires_grad=True) for a in (x, h0, c0)]
    hn, cn = trnn.lstm_step(cell, *xs, maxout=maxout)
    assert hn.grad_fn is not None and cn.grad_fn is not None
    ((hn * torch.from_numpy(gh)).sum()
     + (cn * torch.from_numpy(gc)).sum()).backward()
    return [t.grad for t in (cell.w, cell.b, *xs)]


@pytest.mark.parametrize("maxout", [False, True], ids=["G4", "G5"])
def test_cell_gradients_match_jax_custom_vjp(maxout):
    args = _inputs(11 + maxout, B, D, H, 5 if maxout else 4)
    want = _jax_grads(maxout, *args)
    got = _torch_grads(maxout, *args)
    for name, a, e in zip("w b x h c".split(), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), atol=TOL,
                                   rtol=TOL, err_msg=name)


def test_cell_gradients_need_no_extra_forward_under_no_grad():
    """Without a gradient to take, the cell runs its forward alone: no
    autograd node, the same values."""
    w, bias, x, h0, c0, _, _ = _inputs(3, B, D, H, 5)
    cell = trnn.init_lstm_params(D, H, maxout=True)
    with torch.no_grad():
        cell.w.copy_(torch.from_numpy(w))
        cell.b.copy_(torch.from_numpy(bias))
        hn, cn = trnn.lstm_step(cell, *(torch.from_numpy(a)
                                        for a in (x, h0, c0)), maxout=True)
    assert hn.grad_fn is None
    hp, cp = lk.lstm_cell_plain(cell.w, cell.b, torch.from_numpy(x),
                                torch.from_numpy(h0), torch.from_numpy(c0),
                                maxout=True)
    np.testing.assert_array_equal(hn.numpy(), hp.detach().numpy())
    np.testing.assert_array_equal(cn.numpy(), cp.detach().numpy())


def test_cell_gradient_flows_to_only_what_requires_it():
    """A cell whose weights are frozen still passes the gradient to x."""
    w, bias, x, h0, c0, gh, _ = _inputs(5, B, D, H, 4)
    wt, bt = torch.from_numpy(w), torch.from_numpy(bias)
    xt = torch.tensor(x, requires_grad=True)
    hn, _ = lk.lstm_cell(wt, bt, xt, torch.from_numpy(h0),
                         torch.from_numpy(c0), maxout=False)
    (hn * torch.from_numpy(gh)).sum().backward()
    xr = torch.tensor(x, requires_grad=True)
    hr, _ = lk.lstm_cell_plain(wt, bt, xr, torch.from_numpy(h0),
                               torch.from_numpy(c0), maxout=False)
    (hr * torch.from_numpy(gh)).sum().backward()
    torch.testing.assert_close(xt.grad, xr.grad, atol=TOL, rtol=TOL)


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("maxout", [False, True], ids=["G4", "G5"])
def test_cuda_cell_output_has_grad_fn_and_plain_gradients(cuda_dev, maxout):
    torch.backends.cuda.matmul.allow_tf32 = False
    b, d, h = 50, 1024, 512
    args = _inputs(21 + maxout, b, d, h, 5 if maxout else 4)
    w, bias, x, h0, c0, gh, gc = (torch.from_numpy(a).to(cuda_dev)
                                  for a in args)
    before = lk.launches
    ins = [t.clone().requires_grad_() for t in (w, bias, x, h0, c0)]
    hk, ck = lk.lstm_cell(*ins, maxout=maxout)
    assert lk.launches == before + 1
    assert hk.grad_fn is not None and ck.grad_fn is not None
    got = torch.autograd.grad((hk, ck), ins, (gh, gc))
    ref = [t.clone().requires_grad_() for t in (w, bias, x, h0, c0)]
    hp, cp = lk.lstm_cell_plain(*ref, maxout=maxout)
    want = torch.autograd.grad((hp, cp), ref, (gh, gc))
    for name, a, e in zip("w b x h c".split(), got, want):
        scale = max(1.0, e.abs().max().item())
        assert (a - e).abs().max().item() <= 1e-4 * scale, name
