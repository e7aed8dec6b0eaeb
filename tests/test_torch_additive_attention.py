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


ODD = dict(a=6, d=10, h=6)    # widths that are not multiples of 4


@pytest.mark.parametrize("k", [None, 20], ids=["single", "K20"])
def test_odd_widths_and_wide_beams_plain_match_pallas(k):
    """The plain versions against the Pallas kernels in interpret mode at
    A 6, D 10 (the kernels' scalar instances on the card) and at K = 20
    (two beam groups on the card)."""
    import jax.numpy as jnp

    from unpaired_image_captioning_tpu.ops.attention import (
        _fused_attention_beams_pallas, _fused_attention_pallas)

    args = _attn_inputs(12, n=9, a=ODD["a"], d=ODD["d"], k=k)
    if k is None:
        want = _fused_attention_pallas(*(jnp.asarray(x) for x in args),
                                       block_b=BLOCK_B, interpret=True)
        got = tatt.reference_attention(*_t(args))
    else:
        want = _fused_attention_beams_pallas(
            *(jnp.asarray(x) for x in args), block_b=BLOCK_B, interpret=True)
        got = tatt.reference_attention_beams(*_t(args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    assert not got[3].any()


def test_att_lstm_att_odd_widths_plain_match_pallas():
    import jax.numpy as jnp

    from unpaired_image_captioning_tpu.ops.attention import (
        fused_att_lstm_att)

    args = _step_inputs(13, n=9, **ODD)
    want = fused_att_lstm_att(*(jnp.asarray(x) for x in args),
                              block_b=BLOCK_B, interpret=True)
    got = tatt.att_lstm_att_plain(*_t(args))
    for name, a, e in zip(("h1", "c1", "att2"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), atol=TOL,
                                   rtol=TOL, err_msg=name)


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
    # widths that are not multiples of 4 run the scalar instances
    odd = [x.to(cuda_dev) for x in _t(_attn_inputs(11, 5, 7, 6, 12))]
    assert _rel(aak.additive_attention(*odd),
                tatt.reference_attention(*odd)) <= 1e-4


def _one_slot(args, b):
    """Image b's mask keeps one slot (the last), image 3 stays fully
    masked."""
    mask = args[3]
    mask[b] = 0.0
    mask[b, -1] = 1.0
    return args


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 3, 7, 196])
@pytest.mark.parametrize("k", [1, 3, 5, 16, 17, 20, 40])
def test_cuda_cluster_core_matches_plain(cuda_dev, n, k):
    """The cluster-split core (each image's slots across up to 8 blocks)
    at slot counts below, at and past the cluster and beam groups of one,
    two and three, at the path's widths and at odd ones; a fully masked
    image gives zeros, an image of one slot that slot's row."""
    for a, d in ((512, 512), (ODD["a"], ODD["d"])):
        args = _t(_attn_inputs(20 + n + k, 6, n, a, d, k))
        args = [x.to(cuda_dev) for x in _one_slot(args, 0)]
        before = aak.beams_launches
        got = aak.additive_attention_beams(*args)
        want = tatt.reference_attention_beams(*args)
        assert aak.beams_launches == before + 1
        assert _rel(got, want) <= 1e-4, (a, d)
        assert not got[3].any()
        torch.testing.assert_close(
            got[0], args[4][0, -1].expand(k, d), atol=1e-5, rtol=1e-5)
        if k == 1:
            single = [args[0], args[1][:, 0].contiguous(), *args[2:]]
            got1 = aak.additive_attention(*single)
            assert _rel(got1, tatt.reference_attention(*single)) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("widths", [(512, 512, 512), (6, 10, 6),
                                    (7, 13, 5)], ids=["path", "odd", "odd2"])
def test_cuda_step_fusion_widths(cuda_dev, widths):
    a, d, h = widths
    step = [x.to(cuda_dev) for x in _t(_step_inputs(30 + a, 50, 196, a, d,
                                                     h))]
    with torch.no_grad():
        got = aak.fused_att_lstm_att(*step)
    want = tatt.att_lstm_att_plain(*step)
    for x, e in zip(got, want):
        assert _rel(x, e) <= 1e-4
    assert not got[2][3].any()


@pytest.mark.cuda
def test_cuda_reruns_are_bit_identical(cuda_dev):
    """100 launches of the K-beam core (K 5 and 20) and of the fused step
    give the first launch's bits: no atomics, the cluster's partials summed
    in rank order."""
    for k in (5, 20):
        args = [x.to(cuda_dev) for x in _t(_attn_inputs(40 + k, 50, 196, 512,
                                                        512, k))]
        first = aak.additive_attention_beams(*args)
        for _ in range(100):
            assert torch.equal(aak.additive_attention_beams(*args), first)
    step = [x.to(cuda_dev) for x in _t(_step_inputs(41, 50, 196, 512, 512,
                                                     512))]
    with torch.no_grad():
        first = aak.fused_att_lstm_att(*step)
        for _ in range(100):
            for x, e in zip(aak.fused_att_lstm_att(*step), first):
                assert torch.equal(x, e)


@pytest.mark.cuda
@pytest.mark.parametrize("a,d", [(32000, 32000), (31999, 32001)],
                         ids=["float4", "odd"])
def test_cuda_widths_past_a_block(cuda_dev, a, d):
    """A + D = 64,000 over 8 slots: one query's A and D do not fit a block's
    shared memory, so the query and alpha stream through it in chunks of A
    and the P.V runs in passes over chunks of D. B9a, B9b at K 5 and B9c
    against plain."""
    torch.backends.cuda.matmul.allow_tf32 = False
    for k in (None, 5):
        args = [x.to(cuda_dev) for x in _t(_attn_inputs(50, 5, 8, a, d, k))]
        if k is None:
            got = aak.additive_attention(*args)
            want = tatt.reference_attention(*args)
        else:
            got = aak.additive_attention_beams(*args)
            want = tatt.reference_attention_beams(*args)
        assert _rel(got, want) <= 1e-4, k
        assert not got[3].any()
    step = [x.to(cuda_dev) for x in _t(_step_inputs(51, 5, 8, a, d, 8))]
    with torch.no_grad():
        got = aak.fused_att_lstm_att(*step)
    want = tatt.att_lstm_att_plain(*step)
    for x, e in zip(got, want):
        assert _rel(x, e) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("mix", [("f32", "bf16", "f32", "f32", "bf16"),
                                 ("bf16", "bf16", "bf16", "f32", "bf16"),
                                 ("f32", "bf16", "bf16", "f32", "bf16"),
                                 ("bf16", "bf16", "f32", "f32", "bf16")],
                         ids="/".join)
@pytest.mark.parametrize("k", [None, 3, 5, 20])
def test_cuda_attention_bf16_matches_plain(cuda_dev, mix, k):
    """The bf16 entries of B9a / B9b (ROADMAP A15): p_att / q / alpha /
    mask / emb each f32 or bf16, the output in emb's type; rtol = atol =
    1e-2."""
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}
    args = [x.to(cuda_dev).to(dt[m]) for x, m in zip(
        _t(_attn_inputs(12, 50, 196, 512, 512, k)), mix)]
    fn = aak.additive_attention if k is None else aak.additive_attention_beams
    plain = (tatt.reference_attention if k is None
             else tatt.reference_attention_beams)
    got, want = fn(*args), plain(*args)
    assert got.dtype == want.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), atol=1e-2,
                               rtol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("cast", [False, True])
def test_cuda_step_fusion_bf16_matches_plain(cuda_dev, cast):
    """B9c with bf16 features (f32 p_att after decode_ctx, bf16 emb, query,
    h0d and carry), with f32 or (the cast route) bf16 weights: h1 and c1
    in the carry's type, att2 in emb's; rtol = atol = 1e-2."""
    step = [x.to(cuda_dev) for x in _t(_step_inputs(13, 50, 196, 512, 512,
                                                     512))]
    bf = torch.bfloat16
    for i in (1, 3, 4, 5, 6) + ((7, 8, 9, 10, 11, 12, 13, 14) if cast
                                else ()):
        step[i] = step[i].to(bf)
    before = aak.step_bf16w_launches
    with torch.no_grad():
        got = aak.fused_att_lstm_att(*step)
    want = tatt.att_lstm_att_plain(*step)
    for a, e in zip(got, want):
        assert a.dtype == e.dtype == bf
        torch.testing.assert_close(a.float(), e.float(), atol=1e-2, rtol=1e-2)
    assert aak.step_bf16w_launches - before == int(cast)


def _step_kernel_names():
    """The CUDA kernels torch.profiler records for one B9c step of the cast
    route (every weight a bf16 copy) at the decode's shape."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda", 0)
    step = [x.to(dev) for x in _t(_step_inputs(13, 50, 196, 512, 512, 512))]
    for i in range(1, 15):
        if i != 2:
            step[i] = step[i].to(torch.bfloat16)
    with torch.no_grad():
        aak.fused_att_lstm_att(*step)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            aak.fused_att_lstm_att(*step)
            torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]


@pytest.mark.cuda
def test_cuda_step_bf16_weights_run_decode_gemm(cuda_dev):
    """With a bf16 copy of the weights B9c's two products run decode_gemm's
    kernel (its converting loads), as the f32 weights' do: the profile
    shows it and no other product kernel. The profile runs in a process of
    its own (a process that has profiled many times loses device events)."""
    import multiprocessing

    with multiprocessing.get_context("spawn").Pool(1) as pool:
        names = pool.apply(_step_kernel_names)
    # the profiler may lose a session's first events, never invent one
    assert any("decode_gemm_kernel" in n for n in names), names
    assert not any("rows_gemm" in n for n in names), names
