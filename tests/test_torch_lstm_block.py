"""The port's timestep-blocked LSTM chain (`kernels/lstm_block.py`, plain
versions in `ops/lstm_block.py`) against the JAX package's
`blocked_lstm_chain` on its Pallas route (interpret mode on the CPU), f32,
B 8, T 6, D 24, H 16, for G = 5 (maxout) and G = 4: hs and cs at 1e-5, and
the gradients of w, b, x (through the hoisted `x @ w_i2h + b`), h0 and c0
at 1e-4 * max(1, max|jax|) (f32 sums in another order). A maxout tie
(m1 == m2 at every step) sends the whole gradient to m1, as JAX does.

Card tests carry the `cuda` marker and skip without a card. On a card
machine without jax, run them with

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_lstm_block.py
"""

import numpy as np
import pytest
import torch

from unpaired_image_captioning_tpu_torch.kernels import lstm_block as lb
from unpaired_image_captioning_tpu_torch.ops import lstm_block as lo

B, T, D, H = 8, 6, 24, 16
FWD_TOL = 1e-5
GRAD_TOL = 1e-4


def _inputs(maxout, seed, tie=False):
    g = 5 if maxout else 4
    r = np.random.RandomState(seed)
    w = (r.randn(D + H, g * H) * 0.2).astype(np.float32)
    b = (r.randn(g * H) * 0.1).astype(np.float32)
    if tie:   # m2's columns equal m1's: every gate pair ties at every step
        w[:, 4 * H:] = w[:, 3 * H: 4 * H]
        b[4 * H:] = b[3 * H: 4 * H]
    x = r.randn(B, T, D).astype(np.float32)
    h0 = (r.randn(B, H) * 0.5).astype(np.float32)
    c0 = (r.randn(B, H) * 0.5).astype(np.float32)
    ch = r.randn(T, B, H).astype(np.float32)
    cc = (r.randn(T, B, H) * 0.3).astype(np.float32)
    return (w, b, x, h0, c0), ch, cc


def _jax(arrays, ch, cc, maxout):
    import jax
    import jax.numpy as jnp

    from unpaired_image_captioning_tpu.ops.lstm_block import (
        blocked_lstm_chain)

    def run(w, b, x, h0, c0):
        xc = jnp.einsum("btd,dg->tbg", x, w[:D]) + b
        return blocked_lstm_chain(xc, h0, c0, w[D:], maxout=maxout,
                                  interpret=True)

    def loss(*a):
        hs, cs = run(*a)
        return jnp.sum(hs * ch) + jnp.sum(cs * cc)

    args = [jnp.asarray(a) for a in arrays]
    hs, cs = run(*args)
    grads = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*args)
    return (np.asarray(hs), np.asarray(cs)), [np.asarray(g) for g in grads]


def _port(arrays, ch, cc, maxout):
    w, b, x, h0, c0 = (torch.tensor(a, requires_grad=True) for a in arrays)
    xc = torch.einsum("btd,dg->tbg", x, w[:D]) + b
    hs, cs = lb.blocked_lstm_chain(xc, h0, c0, w[D:], maxout=maxout)
    loss = ((hs * torch.from_numpy(ch)).sum()
            + (cs * torch.from_numpy(cc)).sum())
    loss.backward()
    return ((hs.detach().numpy(), cs.detach().numpy()),
            [t.grad.numpy() for t in (w, b, x, h0, c0)])


@pytest.mark.parametrize("maxout,tie", [(True, False), (False, False),
                                        (True, True)],
                         ids=["maxout", "G4", "maxout-tie"])
def test_chain_matches_pallas_interpret(maxout, tie):
    arrays, ch, cc = _inputs(maxout, seed=1, tie=tie)
    (jhs, jcs), jgrads = _jax(arrays, ch, cc, maxout)
    (hs, cs), grads = _port(arrays, ch, cc, maxout)
    np.testing.assert_allclose(hs, jhs, rtol=0, atol=FWD_TOL)
    np.testing.assert_allclose(cs, jcs, rtol=0, atol=FWD_TOL)
    for name, got, want in zip(["w", "b", "x", "h0", "c0"], grads, jgrads):
        tol = GRAD_TOL * max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=name)
    if tie:   # the whole maxout derivative lands on m1's columns
        w_grad = grads[0]
        assert np.abs(w_grad[:, 4 * H:]).max() == 0.0
        assert np.abs(w_grad[:, 3 * H: 4 * H]).max() > 0.0


def test_plain_forward_is_the_cell_loop():
    """The chain's forward equals T steps of the port's plain fused cell on
    [x_contrib | h] with an identity input block, to rounding."""
    from unpaired_image_captioning_tpu_torch.kernels.lstm_cell import (
        lstm_cell_plain)

    r = np.random.RandomState(3)
    xc = torch.tensor(r.randn(T, B, 5 * H), dtype=torch.float32)
    w = torch.tensor(r.randn(H, 5 * H) * 0.2, dtype=torch.float32)
    h0 = torch.tensor(r.randn(B, H), dtype=torch.float32)
    c0 = torch.tensor(r.randn(B, H), dtype=torch.float32)
    hs, cs, gates = lo.chain_fwd_plain(xc, h0, c0, w, maxout=True)
    w_full = torch.cat([torch.eye(5 * H), w])
    h, c = h0, c0
    for t in range(T):
        h, c = lstm_cell_plain(w_full, torch.zeros(5 * H), xc[t], h, c,
                               maxout=True)
        torch.testing.assert_close(hs[t], h, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(cs[t], c, rtol=1e-6, atol=1e-6)
    assert gates.shape == (T, B, 5 * H)


def test_non_cpu_tensors_never_take_the_plain_version(monkeypatch):
    monkeypatch.setattr(lb, "chain_fwd_plain",
                        lambda *a, **k: pytest.fail("plain version called"))
    monkeypatch.setattr(lb, "chain_bwd_plain",
                        lambda *a, **k: pytest.fail("plain version called"))
    meta = torch.zeros((T, B, 5 * H), device="meta")
    with pytest.raises(ValueError, match="chain_fwd: unsupported device"):
        lb.chain_fwd(meta, *(torch.zeros(1, device="meta"),) * 3,
                     maxout=True)
    with pytest.raises(ValueError, match="chain_bwd: unsupported device"):
        lb.chain_bwd(meta, *(torch.zeros(1, device="meta"),) * 5,
                     maxout=True)


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _rel(got, want):
    return (got - want).abs().max().item() / max(1.0, want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h,maxout", [(50, 17, 512, True),
                                          (50, 17, 512, False),
                                          (8, 6, 16, True), (3, 2, 100, False),
                                          (7, 5, 1030, True)])
def test_cuda_kernels_match_plain(cuda_dev, b, t, h, maxout):
    g = 5 if maxout else 4
    gen = torch.Generator(device=cuda_dev).manual_seed(h)
    xc = torch.randn((t, b, g * h), generator=gen, device=cuda_dev)
    w = torch.randn((h, g * h), generator=gen, device=cuda_dev) / h ** 0.5
    h0 = torch.randn((b, h), generator=gen, device=cuda_dev)
    c0 = torch.randn((b, h), generator=gen, device=cuda_dev)
    dhs = torch.randn((t, b, h), generator=gen, device=cuda_dev)
    dcs = torch.randn((t, b, h), generator=gen, device=cuda_dev)
    f0, b0 = lb.fwd_launches, lb.bwd_launches
    hs, cs, gates = lb.chain_fwd(xc, h0, c0, w, maxout=maxout)
    dg, dh0, dc0 = lb.chain_bwd(gates, cs, c0, dhs, dcs, w, maxout=maxout)
    torch.cuda.synchronize()
    assert (lb.fwd_launches, lb.bwd_launches) == (f0 + 1, b0 + 1)
    phs, pcs, pgates = lo.chain_fwd_plain(xc, h0, c0, w, maxout=maxout)
    pdg, pdh0, pdc0 = lo.chain_bwd_plain(pgates, pcs, c0, dhs, dcs, w,
                                         maxout=maxout)
    for got, want in ((hs, phs), (cs, pcs), (gates, pgates), (dg, pdg),
                      (dh0, pdh0), (dc0, pdc0)):
        assert _rel(got, want) <= 1e-4


@pytest.mark.cuda
def test_cuda_shape_that_cannot_be_co_resident_raises(cuda_dev):
    h = 4096   # more than 16 units on each of the card's SMs
    z = torch.zeros((2, 2, 4 * h), device=cuda_dev)
    with pytest.raises(RuntimeError, match="co-resident"):
        lb.chain_fwd(z, torch.zeros((2, h), device=cuda_dev),
                     torch.zeros((2, h), device=cuda_dev),
                     torch.zeros((h, 4 * h), device=cuda_dev), maxout=False)

