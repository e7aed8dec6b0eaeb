"""The port's training attention (`kernels/mha_train.py`, plain version in
`ops/mha_train.py`) against the Pallas `fused_mha_train` in interpret mode:
forward and `jax.vjp` gradients at dropout rates 0, 0.1 and 0.5 (the same
splitmix32 mask), over padded [B, 1, S], causal [B, T, T] and fully masked
rows. Tolerance 1e-5 (f32 sums in another order).

Card tests carry the `cuda` marker and skip without a card. On a card
machine without jax, run them with

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_mha_train.py
"""

import numpy as np
import pytest
import torch

from unpaired_image_captioning_tpu_torch.kernels import mha_train as mk
from unpaired_image_captioning_tpu_torch.ops import mha_train as mo

B, H, DH = 2, 4, 8
TOL = 1e-5


def _inputs(t, s, mask_kind, seed=0):
    rs = np.random.RandomState(seed)
    d = H * DH
    q = rs.randn(B, t, d).astype(np.float32)
    k = rs.randn(B, s, d).astype(np.float32)
    v = rs.randn(B, s, d).astype(np.float32)
    g = rs.randn(B, t, d).astype(np.float32)
    if mask_kind == "pad":
        keep = np.ones((B, 1, s), bool)
        keep[1, 0, s - 3:] = False
    elif mask_kind == "causal":
        keep = np.broadcast_to(np.tril(np.ones((t, s), bool)), (B, t, s))
        keep = keep & (np.arange(s) < s - 1)[None, None]
    else:                                   # "dead": one row sees nothing
        keep = np.ones((B, t, s), bool)
        keep[0, 1, :] = False
        keep[1, :, ::2] = False
    maskadd = np.where(keep, 0.0, -1e9).astype(np.float32)
    return q, k, v, g, maskadd


CASES = [(5, 7, "pad"), (6, 6, "causal"), (4, 9, "dead")]


@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5])
@pytest.mark.parametrize("t,s,mask_kind", CASES)
def test_matches_pallas_interpret(t, s, mask_kind, rate):
    import jax
    import jax.numpy as jnp

    from unpaired_image_captioning_tpu.ops.mha_train import fused_mha_train

    q, k, v, g, maskadd = _inputs(t, s, mask_kind)
    seed = np.asarray([123457], np.int32)

    def jf(q_, k_, v_):
        return fused_mha_train(q_, k_, v_, jnp.asarray(maskadd),
                               jnp.asarray(seed), H, rate, True)

    jout, vjp = jax.vjp(jf, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jdq, jdk, jdv = vjp(jnp.asarray(g))

    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = mk.mha_train(tq, tk, tv, torch.from_numpy(maskadd),
                       torch.from_numpy(seed), n_heads=H, rate=rate)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=TOL, atol=TOL)
    for got, want in ((tq.grad, jdq), (tk.grad, jdk), (tv.grad, jdv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_keep_mask_is_the_pallas_hash(rate):
    """Bit for bit: the plain mask against `_keep_mask` of the JAX module,
    per (batch, head) block id, at a seed above 2^31 / 0x9E3779B9 so the
    uint32 products wrap."""
    import jax.numpy as jnp

    from unpaired_image_captioning_tpu.ops.mha_train import _keep_mask

    t, s, seed = 7, 11, 2_000_000_011
    got = mo.keep_mask(torch.tensor([seed], dtype=torch.int32), B, H, t, s,
                       rate).numpy()
    for b in range(B):
        for h in range(H):
            want = _keep_mask(jnp.int32(seed), b * H + h, t, s, rate)
            np.testing.assert_array_equal(got[b, h], np.asarray(want))
    frac = got.mean()
    assert abs(frac - (1 - rate)) < 0.12


def test_plain_backward_matches_autograd():
    """The explicit backward equals autograd of the plain forward (the
    seed's mask is a constant of the function)."""
    q, k, v, g, maskadd = _inputs(5, 7, "pad", seed=3)
    seed = torch.tensor([99], dtype=torch.int32)
    tq, tk, tv = (torch.tensor(a, dtype=torch.float64, requires_grad=True)
                  for a in (q, k, v))
    m = torch.from_numpy(maskadd).double()
    out = mo.mha_train_plain(tq, tk, tv, m, seed, n_heads=H, rate=0.3)
    out.backward(torch.from_numpy(g).double())
    dq, dk, dv = mo.mha_train_plain_bwd(tq.detach(), tk.detach(),
                                        tv.detach(), m, seed,
                                        torch.from_numpy(g).double(),
                                        n_heads=H, rate=0.3)
    for got, want in ((dq, tq.grad), (dk, tk.grad), (dv, tv.grad)):
        torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("t,s,mask_kind", CASES + [(70, 130, "dead")])
def test_softmax_stats_are_the_logsumexp(t, s, mask_kind):
    """The forward's row statistics (max m, sum l of exp(s - m)): m + log l
    is the log-sum-exp of the plain scores, fully masked rows included,
    also where T and S span several of the kernel's 64-row tiles; the CPU
    wrapper returns them beside the plain output."""
    q, k, v, _, maskadd = _inputs(t, s, mask_kind, seed=5)
    tq, tk, tv, m = (torch.from_numpy(a).double()
                     for a in (q, k, v, maskadd))
    stats = mo.softmax_stats(tq, tk, m, n_heads=H)
    assert stats.shape == (2, B, H, t)
    scores = torch.einsum("bthd,bshd->bhts", tq.reshape(B, t, H, DH),
                          tk.reshape(B, s, H, DH)) / DH ** 0.5
    scores = torch.where(m[:, None] < 0, mo.NEG, scores)
    torch.testing.assert_close(stats[0] + torch.log(stats[1]),
                               torch.logsumexp(scores, dim=-1), rtol=1e-12,
                               atol=1e-9)
    seed = torch.tensor([7], dtype=torch.int32)
    out, got = mk.mha_train_fwd(tq, tk, tv, m, seed, n_heads=H, rate=0.1)
    torch.testing.assert_close(got, stats, rtol=0, atol=0)
    torch.testing.assert_close(
        out, mo.mha_train_plain(tq, tk, tv, m, seed, n_heads=H, rate=0.1),
        rtol=0, atol=0)


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,s,mask_rows,dh", [(50, 196, 196, 1, 64),
                                                (50, 17, 196, 1, 64),
                                                (50, 17, 17, 17, 64),
                                                (3, 40, 70, 40, 64),
                                                (4, 70, 131, 1, 32),
                                                (3, 129, 67, 129, 128),
                                                (4, 70, 131, 70, 96),
                                                (3, 40, 70, 1, 256),
                                                (2, 37, 99, 37, 256),
                                                (2, 5, 20, 5, 12),
                                                (2, 100, 1500, 1, 64),
                                                (2, 37, 70, 37, 6),
                                                (3, 40, 70, 1, 50),
                                                (2, 33, 45, 33, 384),
                                                (2, 20, 40, 1, 512),
                                                (1, 9, 20, 9, 1024)])
def test_cuda_mha_train_matches_plain(cuda_dev, b, t, s, mask_rows, dh):
    """Outputs, row statistics and gradients against the plain versions;
    T and S off the 64-row tiles; head widths padded in their bucket (96 in
    128's, 12 in 32's) and the 32-row tiles of bucket 256; 1,500 keys;
    widths off 16 bytes (6, 50: 4-byte copies) and past 256 (384, 512,
    1024: column chunks); forward and backward bit-identical on a
    rerun."""
    torch.backends.cuda.matmul.allow_tf32 = False
    n_heads, rate = 8, 0.1
    d = n_heads * dh
    gen = torch.Generator(device=cuda_dev).manual_seed(t + s)
    q, g = (torch.randn((b, t, d), generator=gen, device=cuda_dev)
            for _ in range(2))
    k, v = (torch.randn((b, s, d), generator=gen, device=cuda_dev)
            for _ in range(2))
    keep = torch.rand((b, mask_rows, s), generator=gen, device=cuda_dev) > 0.2
    keep[0] = False                                   # fully masked rows
    maskadd = torch.where(keep, 0.0, -1e9).contiguous()
    seed = torch.tensor([4321], dtype=torch.int32, device=cuda_dev)
    out, stats = mk.mha_train_fwd(q, k, v, maskadd, seed, n_heads=n_heads,
                                  rate=rate)
    out2, stats2 = mk.mha_train_fwd(q, k, v, maskadd, seed, n_heads=n_heads,
                                    rate=rate)
    ref = mo.mha_train_plain(q, k, v, maskadd, seed, n_heads=n_heads,
                             rate=rate)
    ref_stats = mo.softmax_stats(q, k, maskadd, n_heads=n_heads)
    grads = mk.mha_train_bwd(q, k, v, maskadd, seed, g, out, stats,
                             n_heads=n_heads, rate=rate)
    again = mk.mha_train_bwd(q, k, v, maskadd, seed, g, out, stats,
                             n_heads=n_heads, rate=rate)
    refs = mo.mha_train_plain_bwd(q, k, v, maskadd, seed, g,
                                  n_heads=n_heads, rate=rate)
    torch.cuda.synchronize()
    for got, want in zip((out, stats[0], stats[1]) + grads,
                         (ref, ref_stats[0], ref_stats[1]) + refs):
        tol = 1e-4 * max(1.0, want.abs().max().item())
        assert (got - want).abs().max().item() <= tol
    assert torch.equal(out, out2) and torch.equal(stats, stats2)
    for a, c in zip(grads, again):
        assert torch.equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,s,mask_rows,dh", [(50, 196, 196, 1, 64),
                                                (50, 17, 196, 1, 64),
                                                (50, 17, 17, 17, 64),
                                                (50, 16, 16, 1, 64),
                                                (3, 40, 70, 40, 128),
                                                (2, 37, 99, 37, 256),
                                                (2, 37, 70, 37, 6),
                                                (2, 33, 45, 33, 384)])
def test_cuda_mha_train_bf16_matches_plain(cuda_dev, b, t, s, mask_rows, dh):
    """The bf16 entry (q, k, v and g bf16; the bf16 cast points) against the
    plain version at rtol = atol = 1e-2 against each output's scale, every
    bucket, the 4-byte-copy instance and column chunks; a bf16 launch each
    way."""
    n_heads, rate = 8, 0.1
    d = n_heads * dh
    bf = torch.bfloat16
    gen = torch.Generator(device=cuda_dev).manual_seed(t + s)
    q, g = (torch.randn((b, t, d), generator=gen, device=cuda_dev).to(bf)
            for _ in range(2))
    k, v = (torch.randn((b, s, d), generator=gen, device=cuda_dev).to(bf)
            for _ in range(2))
    keep = torch.rand((b, mask_rows, s), generator=gen, device=cuda_dev) > 0.2
    keep[:, :, 0] = True
    maskadd = torch.where(keep, 0.0, -1e9).contiguous()
    seed = torch.tensor([4321], dtype=torch.int32, device=cuda_dev)
    kw = dict(n_heads=n_heads, rate=rate)
    before = (mk.bf16_fwd_launches, mk.bf16_bwd_launches)
    out, stats = mk.mha_train_fwd(q, k, v, maskadd, seed, **kw)
    grads = mk.mha_train_bwd(q, k, v, maskadd, seed, g, out, stats, **kw)
    ref = mo.mha_train_plain(q, k, v, maskadd, seed, **kw)
    ref_stats = mo.softmax_stats(q, k, maskadd, n_heads=n_heads)
    refs = mo.mha_train_plain_bwd(q, k, v, maskadd, seed, g, **kw)
    torch.cuda.synchronize()
    assert (mk.bf16_fwd_launches, mk.bf16_bwd_launches) == (before[0] + 1,
                                                            before[1] + 1)
    for got, want in zip((out, stats[0], stats[1]) + grads,
                         (ref, ref_stats[0], ref_stats[1]) + refs):
        assert got.dtype == want.dtype
        got, want = got.float(), want.float()
        assert ((got - want).abs().max().item()
                <= 1e-2 * max(1.0, want.abs().max().item()))
