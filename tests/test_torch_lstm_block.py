"""The port's timestep-blocked LSTM chain (`kernels/lstm_block.py`, plain
versions in `ops/lstm_block.py`) against the JAX package's
`blocked_lstm_chain` on its Pallas route (interpret mode on the CPU), f32,
B 8, T 6, D 24, H 16, for G = 5 (maxout) and G = 4: hs and cs at 1e-5, and
the gradients of w, b, x (through the hoisted `x @ w_i2h + b`), h0 and c0
at 1e-4 * max(1, max|jax|) (f32 sums in another order). A maxout tie
(m1 == m2 at every step) sends the whole gradient to m1, as JAX does.
The bf16 plain versions (the carry and w_h2h bf16, x_contrib f32) against
the same Pallas route at B 5, T 4, H 24, both G: hs, cs and the four
gradients at rtol = atol = 1e-2. The routing rule `tensor_core` in each
mixture and direction.

Card tests carry the `cuda` marker and skip without a card: the kernels
against the plain versions in f32 and in each bf16 mixture, the
tensor-core instances also at ragged shapes (H 76 and 29, B 37 and 5),
each rerun bit for bit and its counters by the rule. On a card
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


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("carry,w", [("f32", "f32"), ("bf16", "f32"),
                                     ("f32", "bf16"), ("bf16", "bf16")])
def test_tensor_core_rule(carry, w, backward):
    """JAX's cast points: the forward's h @ w is all bf16 only with a bf16
    carry and w_h2h; the backward's dgates.astype(w.dtype) @ w.T whenever
    w_h2h is bf16."""
    types = lb._mixture(
        "rule", {"x": torch.zeros(1)},
        {"h": torch.zeros(1, dtype=BF if carry == "bf16" else torch.float32)},
        torch.zeros(1, dtype=BF if w == "bf16" else torch.float32))
    want = w == "bf16" and (backward or carry == "bf16")
    assert lb.tensor_core(types, backward) is want


BF = torch.bfloat16
B_BF, T_BF, H_BF = 5, 4, 24


@pytest.mark.parametrize("maxout", [True, False], ids=["maxout", "G4"])
def test_chain_bf16_matches_pallas_interpret(maxout):
    """The carry and w_h2h bf16, x_contrib f32 (the mixture the tensor-core
    instances take both ways): the plain versions through the autograd
    Function against JAX's chain on its Pallas route in interpret mode, the
    same bf16 cotangents; rtol = atol = 1e-2."""
    import jax
    import jax.numpy as jnp
    import ml_dtypes

    from unpaired_image_captioning_tpu.ops.lstm_block import (
        blocked_lstm_chain)

    g = 5 if maxout else 4
    r = np.random.RandomState(7 + g)
    xc = r.randn(T_BF, B_BF, g * H_BF).astype(np.float32)
    h0, c0 = ((r.randn(B_BF, H_BF) * 0.5).astype(ml_dtypes.bfloat16)
              for _ in range(2))
    w = (r.randn(H_BF, g * H_BF) / np.sqrt(H_BF)).astype(ml_dtypes.bfloat16)
    dhs, dcs = (r.randn(T_BF, B_BF, H_BF).astype(ml_dtypes.bfloat16)
                for _ in range(2))
    (jhs, jcs), vjp = jax.vjp(
        lambda *a: blocked_lstm_chain(*a, maxout=maxout, interpret=True),
        *(jnp.asarray(v) for v in (xc, h0, c0, w)))
    jgrads = vjp((jnp.asarray(dhs), jnp.asarray(dcs)))

    def tt(v):
        return torch.from_numpy(np.asarray(v, np.float32)).to(
            BF if v.dtype == ml_dtypes.bfloat16 else torch.float32)

    leaves = [tt(v).requires_grad_() for v in (xc, h0, c0, w)]
    hs, cs = lb.blocked_lstm_chain(*leaves, maxout=maxout)
    torch.autograd.backward([hs, cs], [tt(dhs), tt(dcs)])
    for name, got, want in [("hs", hs, jhs), ("cs", cs, jcs)] + [
            (k, v.grad, j) for k, v, j in zip(
                ["dx_contrib", "dh0", "dc0", "dw_h2h"], leaves, jgrads)]:
        want = np.asarray(want)
        assert got.dtype == (BF if want.dtype == ml_dtypes.bfloat16
                             else torch.float32), name
        np.testing.assert_allclose(got.detach().float().numpy(),
                                   want.astype(np.float32), rtol=1e-2,
                                   atol=1e-2, err_msg=name)


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
                                          (7, 5, 1030, True),
                                          (13, 4, 52, True),
                                          (61, 3, 36, False)])
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
    # both directions sum in a fixed order: a rerun gives the same bits
    again = (lb.chain_fwd(xc, h0, c0, w, maxout=maxout)
             + lb.chain_bwd(gates, cs, c0, dhs, dcs, w, maxout=maxout))
    assert all(torch.equal(a, c)
               for a, c in zip(again, (hs, cs, gates, dg, dh0, dc0)))


@pytest.mark.cuda
def test_cuda_shape_that_cannot_be_co_resident_raises(cuda_dev):
    h = 4096   # more than 16 units on each of the card's SMs
    z = torch.zeros((2, 2, 4 * h), device=cuda_dev)
    with pytest.raises(RuntimeError, match="co-resident"):
        lb.chain_fwd(z, torch.zeros((2, h), device=cuda_dev),
                     torch.zeros((2, h), device=cuda_dev),
                     torch.zeros((h, 4 * h), device=cuda_dev), maxout=False)



@pytest.mark.cuda
@pytest.mark.parametrize("carry,wdt", [("bf16", "bf16"), ("bf16", "f32"),
                                       ("f32", "bf16")])
@pytest.mark.parametrize("maxout", [True, False])
def test_cuda_kernels_bf16_match_plain(cuda_dev, carry, wdt, maxout):
    """The bf16 entries of B10 (ROADMAP A15): f32 x_contrib with the carry
    and w_h2h each f32 or bf16, forward and backward; rtol = atol = 1e-2."""
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}
    b, t, h = 50, 17, 512
    g = 5 if maxout else 4
    gen = torch.Generator(device=cuda_dev).manual_seed(h + 1)
    xc = torch.randn((t, b, g * h), generator=gen, device=cuda_dev)
    w = (torch.randn((h, g * h), generator=gen, device=cuda_dev)
         / h ** 0.5).to(dt[wdt])
    h0, c0, dhs, dcs = (
        (torch.randn(s, generator=gen, device=cuda_dev) * 0.5).to(dt[carry])
        for s in ((b, h), (b, h), (t, b, h), (t, b, h)))
    _bf16_chain_check(xc, h0, c0, w, dhs, dcs, maxout)


def _bf16_chain_check(xc, h0, c0, w, dhs, dcs, maxout):
    """Forward and backward against the plain versions at rtol = atol =
    1e-2, types equal; a rerun gives the same bits; the tensor-core
    counters move by the rule."""
    types = lb._mixture("check", {"x": xc}, {"h": h0}, w)
    before = (lb.tc_fwd_launches, lb.tc_bwd_launches)
    hs, cs, gates = lb.chain_fwd(xc, h0, c0, w, maxout=maxout)
    phs, pcs, pgates = lo.chain_fwd_plain(xc, h0, c0, w, maxout=maxout)
    for a, e in ((hs, phs), (cs, pcs), (gates, pgates)):
        assert a.dtype == e.dtype
        torch.testing.assert_close(a.float(), e.float(), atol=1e-2,
                                   rtol=1e-2)
    got = lb.chain_bwd(gates, cs, c0, dhs, dcs, w, maxout=maxout)
    want = lo.chain_bwd_plain(gates, cs, c0, dhs, dcs, w, maxout=maxout)
    for a, e in zip(got, want):
        assert a.dtype == e.dtype
        torch.testing.assert_close(a.float(), e.float(), atol=1e-2,
                                   rtol=1e-2)
    assert (lb.tc_fwd_launches - before[0], lb.tc_bwd_launches - before[1]
            ) == (int(lb.tensor_core(types, False)),
                  int(lb.tensor_core(types, True)))
    again = (lb.chain_fwd(xc, h0, c0, w, maxout=maxout)
             + lb.chain_bwd(gates, cs, c0, dhs, dcs, w, maxout=maxout))
    assert all(torch.equal(a, e) for a, e in
               zip(again, (hs, cs, gates) + tuple(got)))


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h", [(37, 5, 76), (5, 3, 29), (70, 2, 40),
                                   (50, 17, 512)])
@pytest.mark.parametrize("carry", ["bf16", "f32"])
@pytest.mark.parametrize("maxout", [True, False])
def test_cuda_tensor_core_matches_plain(cuda_dev, b, t, h, carry, maxout):
    """The tensor-core instances (w_h2h bf16: the backward with either
    carry, the forward with a bf16 one) at the path's shape and at ragged
    ones: H 76 (rows off 16 bytes), 29 (odd) and 40, B 37, 5 and 70 (not
    multiples of 16; 70 takes two passes of rows)."""
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}
    g = 5 if maxout else 4
    gen = torch.Generator(device=cuda_dev).manual_seed(b * h + t)
    xc = torch.randn((t, b, g * h), generator=gen, device=cuda_dev)
    w = (torch.randn((h, g * h), generator=gen, device=cuda_dev)
         / h ** 0.5).to(torch.bfloat16)
    h0, c0, dhs, dcs = (
        (torch.randn(s, generator=gen, device=cuda_dev) * 0.5).to(dt[carry])
        for s in ((b, h), (b, h), (t, b, h), (t, b, h)))
    _bf16_chain_check(xc, h0, c0, w, dhs, dcs, maxout)
