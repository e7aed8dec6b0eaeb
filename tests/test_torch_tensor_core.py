"""The bf16 tensor-core instances: B1's all-bf16 LSTM cell
(`csrc/lstm_cell.cu::lstm_cell_tc_kernel`) and the bf16 GEMM core of the
whole training layers B6 / B7 (`csrc/train_gemm.cuh::train_gemm_bf16_kernel`).

On the CPU: the routing rules (which mixture reaches the tensor cores) as
the wrappers state them, and that a CPU tensor takes the plain version and
counts no launch. On a card: each instance against its plain version at
small and ragged shapes (widths not multiples of 8 or 16 take the
element-by-element copies), rtol = atol = 1e-2 for the cell (elementwise)
and 1e-2 of each tensor's scale for the layers, the backward bit for bit on
a rerun, and the tensor-core counters: every all-bf16 cell and every bf16
layer call goes through the tensor cores, every other mixture does not.

Card tests carry the `cuda` marker and skip without a card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_tensor_core.py
"""

import itertools

import numpy as np
import pytest
import torch

from unpaired_image_captioning_tpu_torch.kernels import build
from unpaired_image_captioning_tpu_torch.kernels import layer_train as ltk
from unpaired_image_captioning_tpu_torch.kernels import lstm_cell as lk
from unpaired_image_captioning_tpu_torch.ops import layer_train as lto

F32, BF16 = torch.float32, torch.bfloat16
MIXES = list(itertools.product((F32, BF16), repeat=3))   # x, (w, b), (h, c)
TOL = 1e-2


def _cell_args(rs, b, d, h, maxout, mix, device="cpu"):
    g = 5 if maxout else 4
    tx, tw, th = mix
    w = torch.from_numpy(((rs.rand(d + h, g * h) - 0.5) / 8)
                         .astype(np.float32)).to(device, tw)
    bias = torch.from_numpy(((rs.rand(g * h) - 0.5) / 8)
                            .astype(np.float32)).to(device, tw)
    x = torch.from_numpy(rs.randn(b, d).astype(np.float32)).to(device, tx)
    h0, c0 = (torch.from_numpy(rs.randn(b, h).astype(np.float32))
              .to(device, th) for _ in range(2))
    return w, bias, x, h0, c0


@pytest.mark.parametrize("mix", MIXES, ids=lambda m: "/".join(
    "bf16" if t == BF16 else "f32" for t in m))
def test_lstm_cell_routing_rule(mix):
    """Only x, (w, b) and (h, c) all bf16 reach the tensor cores: a product
    with an f32 operand is an f32 product in JAX."""
    w, bias, x, h0, c0 = _cell_args(np.random.RandomState(0), 2, 8, 4, False,
                                    mix)
    types = lk.mixture(x, w, bias, h0, c0)
    assert lk.tensor_core(types) == all(t == BF16 for t in mix)
    # bit 3 (h' and c' kept f32, additive_attention.cu's decode step) does
    # not change the route
    assert lk.tensor_core(types | 8) == lk.tensor_core(types)


@pytest.mark.parametrize("maxout", [False, True])
def test_lstm_cell_cpu_bf16_is_plain(maxout):
    """All-bf16 CPU tensors take the plain version and count no launch."""
    args = _cell_args(np.random.RandomState(1), 3, 10, 6, maxout,
                      (BF16,) * 3)
    before = (lk.launches, lk.bf16_launches, lk.tc_launches)
    got = lk.lstm_cell(*args, maxout=maxout)
    want = lk.lstm_cell_plain(*args, maxout=maxout)
    assert (lk.launches, lk.bf16_launches, lk.tc_launches) == before
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert got[0].dtype == got[1].dtype == BF16


@pytest.mark.parametrize("dtype,tc", [(F32, False), (BF16, True),
                                      (torch.float16, False)])
def test_layer_train_routing_rule(dtype, tc):
    """A bf16 layer call runs its products on the tensor cores; f32 (and
    any type the kernels refuse) does not."""
    assert ltk.tensor_core(dtype) is tc


def _layer_inputs(rs, b, t, d, f, dtype, device="cpu", s=None):
    def arr(*shape, scale=1.0):
        return torch.from_numpy((rs.randn(*shape) * scale)
                                .astype(np.float32)).to(device)

    keys = lto.DEC_WEIGHTS if s else lto.ENC_WEIGHTS
    shapes = {"wqkv": (d, 3 * d), "bqkv": (3 * d,), "wo": (d, d),
              "wq": (d, d), "wo2": (d, d), "w1": (d, f), "b1": (f,),
              "w2": (f, d)}
    w = {}
    for k in keys:
        if k.startswith("l") and k.endswith("s"):
            w[k] = 1 + arr(d, scale=0.1)
        else:
            w[k] = arr(*shapes.get(k, (d,)),
                       scale=0.1 if k.startswith(("l", "b")) else d ** -0.5)
    w = {k: v.to(dtype) for k, v in w.items()}
    x, g = arr(b, t, d).to(dtype), arr(b, t, d).to(dtype)
    keep = torch.from_numpy(rs.rand(b, 1, s or t) > 0.2).to(device)
    keep[:, :, 0] = True
    maskadd = torch.where(keep, 0.0, -1e9).contiguous()
    return x, g, maskadd, w


def test_layer_train_cpu_bf16_is_plain():
    """bf16 CPU tensors take the plain version and count no launch."""
    x, g, maskadd, w = _layer_inputs(np.random.RandomState(2), 1, 3, 8, 8,
                                     BF16)
    seed = torch.tensor([7], dtype=torch.int32)
    kw = dict(n_heads=2, rate=0.0)
    counters = ("enc_fwd_launches", "enc_bwd_launches",
                "bf16_enc_fwd_launches", "tc_enc_fwd_launches",
                "tc_enc_bwd_launches")
    before = [getattr(ltk, c) for c in counters]
    out, saved = ltk.enc_layer_fwd(x, maskadd, seed, w, **kw)
    grads = ltk.enc_layer_bwd(x, maskadd, seed, w, saved, g, **kw)
    assert [getattr(ltk, c) for c in counters] == before
    ref, x2 = lto.enc_fwd_plain(x, maskadd, seed,
                                *(w[k] for k in lto.ENC_WEIGHTS), **kw)
    assert torch.equal(out, ref) and torch.equal(saved[0], x2)
    assert out.dtype == BF16 and all(gr.dtype == BF16 for gr in grads)


# ---------------------------------------------------------------------------
# on a card


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("b,d,h,maxout", [
    (50, 1024, 512, True),    # the maxout cells at batch 50: cluster 8
    (50, 512, 256, False),    # the NMT encoder
    (150, 1024, 512, True),   # beam 3 x 50
    (750, 1024, 512, False),  # beam 15 x 50: no cluster
    (5, 100, 76, True),       # D, H not multiples of 8: element copies
    (37, 13, 29, False),      # ragged everything
    (70, 24, 40, True),       # 16-byte copies, H not a multiple of 16
])
def test_cuda_lstm_cell_tc_matches_plain(cuda_dev, b, d, h, maxout):
    rs = np.random.RandomState(b + d + h)
    args = _cell_args(rs, b, d, h, maxout, (BF16,) * 3, cuda_dev)
    before = (lk.launches, lk.bf16_launches, lk.tc_launches)
    got = lk.lstm_cell(*args, maxout=maxout)
    again = lk.lstm_cell(*args, maxout=maxout)
    want = lk.lstm_cell_plain(*args, maxout=maxout)
    torch.cuda.synchronize()
    assert (lk.launches, lk.bf16_launches, lk.tc_launches) == (
        before[0] + 2, before[1] + 2, before[2] + 2)
    for a, c in zip(got, want):
        assert a.dtype == c.dtype == BF16
        torch.testing.assert_close(a.float(), c.float(), atol=TOL, rtol=TOL)
    assert all(torch.equal(a, c) for a, c in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("mix", MIXES[:-1], ids=lambda m: "/".join(
    "bf16" if t == BF16 else "f32" for t in m))
def test_cuda_lstm_cell_mixed_stays_on_fma(cuda_dev, mix):
    args = _cell_args(np.random.RandomState(3), 50, 64, 32, True, mix,
                      cuda_dev)
    before = (lk.launches, lk.tc_launches)
    lk.lstm_cell(*args, maxout=True)
    torch.cuda.synchronize()
    assert (lk.launches, lk.tc_launches) == (before[0] + 1, before[1])


@pytest.mark.cuda
def test_cuda_lstm_cell_tc_plans_and_refusal(cuda_dev):
    """plan_tc splits K across a cluster at batch 50 and not at beam
    batches; the mixed entry refuses the all-bf16 mixture (it has its
    own)."""
    assert lk.plan_tc(50, 1024, 512)["cluster"] == 8
    assert lk.plan_tc(50, 512, 256)["cluster"] == 4
    assert lk.plan_tc(750, 1024, 512)["cluster"] == 1
    args = _cell_args(np.random.RandomState(4), 4, 16, 8, False, (BF16,) * 3,
                      cuda_dev)
    w, bias, x, h0, c0 = args
    ho, co = torch.empty_like(h0), torch.empty_like(c0)
    err = build.load().lstm_cell_mixed(
        x.data_ptr(), h0.data_ptr(), c0.data_ptr(), w.data_ptr(),
        bias.data_ptr(), ho.data_ptr(), co.data_ptr(), 4, 16, 8, 4, 7,
        torch.cuda.current_stream(cuda_dev).cuda_stream)
    assert err != 0


def _scaled_close(got, want):
    for a, c in zip(got, want):
        assert a.dtype == c.dtype and a.shape == c.shape
        a, c = a.float(), c.float()
        assert (a - c).abs().max().item() <= TOL * max(1.0,
                                                       c.abs().max().item())


_LAYER_COUNTERS = ("tc_enc_fwd_launches", "tc_enc_bwd_launches",
                   "tc_dec_fwd_launches", "tc_dec_bwd_launches")


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,d,f,heads", [
    (2, 37, 64, 96, 2),     # 74 rows: one ragged row tile
    (3, 29, 40, 72, 5),     # widths multiples of 8, not of 16
    (3, 29, 30, 45, 5),     # element copies, `one` epilogues
    (2, 19, 100, 200, 2),   # d % 8 = 4
])
def test_cuda_enc_layer_tc_matches_plain(cuda_dev, b, t, d, f, heads):
    rs = np.random.RandomState(t + d)
    x, g, maskadd, w = _layer_inputs(rs, b, t, d, f, BF16, cuda_dev)
    seed = torch.tensor([4321], dtype=torch.int32, device=cuda_dev)
    kw = dict(n_heads=heads, rate=0.1)
    before = [getattr(ltk, c) for c in _LAYER_COUNTERS]
    out, saved = ltk.enc_layer_fwd(x, maskadd, seed, w, **kw)
    grads = ltk.enc_layer_bwd(x, maskadd, seed, w, saved, g, **kw)
    again = ltk.enc_layer_bwd(x, maskadd, seed, w, saved, g, **kw)
    ws = [w[k] for k in lto.ENC_WEIGHTS]
    ref, x2 = lto.enc_fwd_plain(x, maskadd, seed, *ws, **kw)
    refs = lto.enc_bwd_plain(x, maskadd, seed, saved[0], g, *ws, **kw,
                             relu_active=saved[-1] > 0)
    torch.cuda.synchronize()
    assert [getattr(ltk, c) for c in _LAYER_COUNTERS] == [
        before[0] + 1, before[1] + 2, before[2], before[3]]
    assert all(s.dtype == BF16 for i, s in enumerate(saved) if i != 4)
    assert saved[4].dtype == F32   # the softmax statistics
    _scaled_close((out, saved[0]) + grads, (ref, x2) + refs)
    assert all(torch.equal(a, c) for a, c in zip(grads, again))


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,s,d,f,heads", [
    (3, 9, 70, 64, 128, 4),
    (3, 9, 70, 30, 45, 5),
    (2, 17, 50, 100, 510, 2),
])
def test_cuda_dec_layer_tc_matches_plain(cuda_dev, b, t, s, d, f, heads):
    rs = np.random.RandomState(s + d)
    x, g, sm, w = _layer_inputs(rs, b, t, d, f, BF16, cuda_dev, s=s)
    mk, mv = (torch.from_numpy(rs.randn(b, s, d).astype(np.float32))
              .to(cuda_dev, BF16) for _ in range(2))
    pos = torch.arange(t, device=cuda_dev)
    tm = torch.where((pos[None, :] <= pos[:, None])[None].expand(b, t, t),
                     0.0, -1e9).contiguous()
    seeds = torch.tensor([4321, 4321 ^ 0x55555555], dtype=torch.int32,
                         device=cuda_dev)
    kw = dict(n_heads=heads, rate=0.1)
    before = [getattr(ltk, c) for c in _LAYER_COUNTERS]
    out, saved = ltk.dec_layer_fwd(x, mk, mv, tm, sm, seeds, w, **kw)
    grads = ltk.dec_layer_bwd(x, mk, mv, tm, sm, seeds, w, saved, g, **kw)
    again = ltk.dec_layer_bwd(x, mk, mv, tm, sm, seeds, w, saved, g, **kw)
    ws = [w[k] for k in lto.DEC_WEIGHTS]
    ref, x2, x3 = lto.dec_fwd_plain(x, mk, mv, tm, sm, seeds, *ws, **kw)
    refs = lto.dec_bwd_plain(x, mk, mv, tm, sm, seeds, saved[0], saved[1],
                             g, *ws, **kw, relu_active=saved[-1] > 0)
    torch.cuda.synchronize()
    assert [getattr(ltk, c) for c in _LAYER_COUNTERS] == [
        before[0], before[1], before[2] + 1, before[3] + 2]
    _scaled_close((out, saved[0], saved[1]) + grads, (ref, x2, x3) + refs)
    assert all(torch.equal(a, c) for a, c in zip(grads, again))


@pytest.mark.cuda
def test_cuda_layer_f32_stays_on_fma(cuda_dev):
    rs = np.random.RandomState(5)
    x, g, maskadd, w = _layer_inputs(rs, 2, 11, 32, 64, F32, cuda_dev)
    seed = torch.tensor([1], dtype=torch.int32, device=cuda_dev)
    before = [getattr(ltk, c) for c in _LAYER_COUNTERS]
    out, saved = ltk.enc_layer_fwd(x, maskadd, seed, w, n_heads=2, rate=0.0)
    ltk.enc_layer_bwd(x, maskadd, seed, w, saved, g, n_heads=2, rate=0.0)
    torch.cuda.synchronize()
    assert [getattr(ltk, c) for c in _LAYER_COUNTERS] == before
    assert all(s.dtype == F32 for s in saved)
