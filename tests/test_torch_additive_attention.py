"""PyTorch port, ops/attention.py: the plain versions of the three
additive-attention kernels against the JAX package's Pallas kernels in
interpret mode (`_fused_attention_pallas`, `_fused_attention_beams_pallas`,
`fused_att_lstm_att`), within 1e-5 (f32), on a padded mask, a fully masked
row and a batch of 5 over Pallas blocks of 4. The single-query wrapper's
gradient matches `jax.grad` of `fused_additive_attention` (its custom VJP);
the step-fused wrapper raises when asked for a gradient.

On a CUDA card (`cuda` marker, skipped without one) each kernel is held
against its plain version within 1e-4 * max(1, max|plain|). On a card
machine without jax:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_additive_attention.py
"""

import numpy as np
import pytest
import torch

from unpaired_image_captioning_tpu_torch.kernels import (
    additive_attention as aak)
from unpaired_image_captioning_tpu_torch.ops import attention as tatt

torch.set_num_threads(1)
TOL = 1e-5
B, N, A, D, K, H, BLOCK_B = 5, 7, 8, 12, 3, 12, 4


def _mask(b, n):
    m = np.ones((b, n), np.float32)
    m[1, n // 2:] = 0.0          # padded slots
    m[3, :] = 0.0                # a fully masked row
    return m


def _attn_inputs(seed, b=B, n=N, a=A, d=D, k=None):
    rs = np.random.RandomState(seed)
    q_shape = (b, a) if k is None else (b, k, a)
    return (rs.randn(b, n, a).astype(np.float32),
            rs.randn(*q_shape).astype(np.float32),
            (rs.randn(a, 1) / np.sqrt(a)).astype(np.float32),
            _mask(b, n), rs.randn(b, n, d).astype(np.float32))


def _t(arrays, **kw):
    return [torch.tensor(a, **kw) for a in arrays]


def _step_inputs(seed, b=B, n=N, a=A, d=D, h=H):
    rs = np.random.RandomState(seed)

    def u(*shape, fan):
        return (rs.uniform(-1, 1, shape) / np.sqrt(fan)).astype(np.float32)

    return [rs.randn(b, n, a).astype(np.float32),        # p_att
            rs.randn(b, n, d).astype(np.float32),        # att_emb
            _mask(b, n),
            rs.randn(b, a).astype(np.float32),           # q1
            rs.randn(b, h).astype(np.float32),           # h0d
            rs.randn(b, h).astype(np.float32),           # h1_prev
            rs.randn(b, h).astype(np.float32),           # c1_prev
            u(2 * h + d, 5 * h, fan=h), u(5 * h, fan=h),  # w1, b1
            u(d, h, fan=d), u(h, fan=d),                  # emb2
            u(h, a, fan=h), u(a, fan=h),                  # h2att2
            u(a, 1, fan=a), u(a, 1, fan=a)]               # alpha1, alpha2


def test_single_query_plain_matches_pallas():
    import jax.numpy as jnp

    from unpaired_image_captioning_tpu.ops.attention import (
        _fused_attention_pallas)

    args = _attn_inputs(0)
    want = _fused_attention_pallas(*(jnp.asarray(x) for x in args),
                                   block_b=BLOCK_B, interpret=True)
    got = tatt.reference_attention(*_t(args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    assert not got[3].any()                   # fully masked row -> zeros
    before = aak.launches
    np.testing.assert_array_equal(aak.additive_attention(*_t(args)).numpy(),
                                  got.numpy())
    assert aak.launches == before             # CPU: the plain version


def test_beams_plain_matches_pallas():
    import jax.numpy as jnp

    from unpaired_image_captioning_tpu.ops.attention import (
        _fused_attention_beams_pallas)

    args = _attn_inputs(1, k=K)
    want = _fused_attention_beams_pallas(*(jnp.asarray(x) for x in args),
                                         block_b=BLOCK_B, interpret=True)
    got = tatt.reference_attention_beams(*_t(args))
    assert got.shape == (B, K, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    # each beam is the single-query function of its own query
    p_att, q, alpha, mask, emb = _t(args)
    for k in range(K):
        np.testing.assert_allclose(
            got[:, k].numpy(),
            tatt.reference_attention(p_att, q[:, k].contiguous(), alpha,
                                     mask, emb).numpy(), atol=1e-6)
    before = aak.beams_launches
    np.testing.assert_array_equal(
        aak.additive_attention_beams(*_t(args)).numpy(), got.numpy())
    assert aak.beams_launches == before


def test_att_lstm_att_plain_matches_pallas():
    import jax.numpy as jnp

    from unpaired_image_captioning_tpu.ops.attention import (
        fused_att_lstm_att)

    args = _step_inputs(2)
    want = fused_att_lstm_att(*(jnp.asarray(x) for x in args),
                              block_b=BLOCK_B, interpret=True)
    got = tatt.att_lstm_att_plain(*_t(args))
    for name, a, e in zip(("h1", "c1", "att2"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), atol=TOL,
                                   rtol=TOL, err_msg=name)
    before = aak.step_launches
    with torch.no_grad():
        again = aak.fused_att_lstm_att(*_t(args))
    for a, e in zip(again, got):
        np.testing.assert_array_equal(a.numpy(), e.numpy())
    assert aak.step_launches == before


def test_single_query_gradient_matches_jax_custom_vjp():
    import jax
    import jax.numpy as jnp

    from unpaired_image_captioning_tpu.ops.attention import (
        fused_additive_attention)

    args = _attn_inputs(3)
    g = np.random.RandomState(4).randn(B, D).astype(np.float32)

    def loss(p_att, q, alpha, emb, mask):
        out = fused_additive_attention(p_att, q, alpha, mask, emb,
                                       block_b=BLOCK_B, interpret=True)
        return jnp.sum(out * g)

    p_att, q, alpha, mask, emb = args
    want = jax.grad(loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(x) for x in (p_att, q, alpha, emb, mask)))
    tp, tq, ta, te = _t((p_att, q, alpha, emb), requires_grad=True)
    out = aak.additive_attention(tp, tq, ta, torch.from_numpy(mask), te)
    assert out.grad_fn is not None
    (out * torch.from_numpy(g)).sum().backward()
    for name, t, e in zip(("p_att", "att_h", "alpha", "att_emb"),
                          (tp, tq, ta, te), want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(e), atol=TOL,
                                   rtol=TOL, err_msg=name)


def test_beams_gradient_is_the_plain_versions():
    args = _attn_inputs(5, k=K)
    g = torch.from_numpy(np.random.RandomState(6).randn(B, K, D)
                         .astype(np.float32))
    grads = []
    for fn in (aak.additive_attention_beams, tatt.reference_attention_beams):
        p_att, q, alpha, mask, emb = _t(args)
        ins = [t.requires_grad_() for t in (p_att, q, alpha, emb)]
        (fn(p_att, q, alpha, mask, emb) * g).sum().backward()
        grads.append([t.grad for t in ins])
    for a, e in zip(*grads):
        torch.testing.assert_close(a, e, atol=TOL, rtol=TOL)


def test_att_lstm_att_raises_when_a_gradient_is_required():
    args = _t(_step_inputs(7))
    args[7].requires_grad_()                     # w1
    with pytest.raises(RuntimeError, match="no gradient"):
        aak.fused_att_lstm_att(*args)
    with torch.no_grad():
        h1, _, _ = aak.fused_att_lstm_att(*args)
    assert h1.shape == (B, H)


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _rel(got, want):
    return ((got - want).abs().max().item()
            / max(1.0, want.abs().max().item()))


SHAPES = [(50, 196, 512, 512), (B, N, A, D)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,a,d", SHAPES, ids=["full", "ragged"])
@pytest.mark.parametrize("k", [None, 3, 5, 16, 20, 40],
                         ids=["single", "K3", "K5", "K16", "K20", "K40"])
def test_cuda_attention_matches_plain(cuda_dev, b, n, a, d, k):
    torch.backends.cuda.matmul.allow_tf32 = False
    args = [x.to(cuda_dev) for x in _t(_attn_inputs(8, b, n, a, d, k))]
    if k is None:
        before = aak.launches
        got = aak.additive_attention(*args)
        want = tatt.reference_attention(*args)
        assert aak.launches == before + 1
    else:
        before = aak.beams_launches
        got = aak.additive_attention_beams(*args)
        want = tatt.reference_attention_beams(*args)
        assert aak.beams_launches == before + 1
    assert _rel(got, want) <= 1e-4
    assert not got[3].any()


@pytest.mark.cuda
def test_cuda_attention_backward_and_step_fusion(cuda_dev):
    torch.backends.cuda.matmul.allow_tf32 = False
    args = [x.to(cuda_dev) for x in _t(_attn_inputs(9, 50, 196, 512, 512))]
    for t in (args[0], args[1], args[2], args[4]):
        t.requires_grad_()
    out = aak.additive_attention(*args)
    assert out.grad_fn is not None
    step = [x.to(cuda_dev) for x in _t(_step_inputs(10, 50, 196, 512, 512,
                                                     512))]
    before = aak.step_launches
    with torch.no_grad():
        got = aak.fused_att_lstm_att(*step)
    want = tatt.att_lstm_att_plain(*step)
    assert aak.step_launches == before + 1
    for a, e in zip(got, want):
        assert _rel(a, e) <= 1e-4
    odd = [x.to(cuda_dev) for x in _t(_attn_inputs(11, 5, 7, 6, 12))]
    with pytest.raises(ValueError, match="multiple of 4"):
        aak.additive_attention(*odd)
