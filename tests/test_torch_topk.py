"""PyTorch port, ops/topk.py: exact row top-k in lax.top_k order against the
JAX package's Pallas kernels in interpret mode (values and indices equal),
and, on a CUDA card, the CUDA kernels against their plain versions.

Card tests carry the `cuda` marker and skip without a card. On a card
machine without jax, run them with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_topk.py
"""

import numpy as np
import pytest
import torch

from unpaired_image_captioning_tpu_torch.kernels import build
from unpaired_image_captioning_tpu_torch.kernels import chunked_topk as ck
from unpaired_image_captioning_tpu_torch.kernels import lstm_cell as lk
from unpaired_image_captioning_tpu_torch.kernels import row_topk as tk
from unpaired_image_captioning_tpu_torch.ops import topk as ot
from unpaired_image_captioning_tpu_torch.ops.topk import row_topk

torch.set_num_threads(1)
V = 1100


def _jax_topk(x, k):
    """The JAX package's kernel for k, run as its own tests run it."""
    import jax.numpy as jnp

    from unpaired_image_captioning_tpu.ops import topk as jtopk

    xj = jnp.asarray(x)
    if k <= jtopk.MAX_ITERATIVE_K:
        v, i = jtopk._row_topk_pallas(xj, k=k, interpret=True)
    else:
        v, i = jtopk._lane_topk_pallas(xj, k=k, m=jtopk._lane_m_for(k),
                                       interpret=True)
    return np.asarray(v), np.asarray(i)


def _rows(seed):
    rs = np.random.RandomState(seed)
    x = rs.randn(16, V).astype(np.float32)
    x[:4] = np.round(x[:4] * 2) / 2          # many exact ties
    x[4:6] = -np.inf                          # all -inf rows
    x[6:8] = -np.inf                          # -inf tails behind ties
    x[6:8, 9] = 1.0
    x[6:8, 137] = 1.0
    x[8:10] = -1e10                           # dead beam rows
    return x


@pytest.mark.parametrize("k", [1, 2, 3, 5, 15])
def test_row_topk_matches_jax_kernel(k):
    x = _rows(k)
    jv, ji = _jax_topk(x, k)
    tv, ti = row_topk(torch.from_numpy(x), k)
    np.testing.assert_array_equal(tv.numpy(), jv)
    np.testing.assert_array_equal(ti.numpy(), ji)


def test_row_topk_ties_take_lowest_index():
    x = np.full((2, 256), -5.0, np.float32)
    x[:, 7] = x[:, 100] = 2.0
    x[:, 3] = x[:, 250] = 1.0
    _, ti = row_topk(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(ti.numpy()[0], [7, 100, 3, 250])


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("r,v,k", [(250, 9488, 5), (750, 8571, 15),
                                   (150, 9488, 3), (37, 1100, 1),
                                   (37, 1100, 2), (37, 1100, 16)])
def test_cuda_row_topk_matches_plain(cuda_dev, r, v, k):
    g = torch.Generator(device=cuda_dev).manual_seed(k)
    x = torch.randn((r, v), generator=g, device=cuda_dev)
    x[:8] = torch.round(x[:8] * 2) / 2
    x[8:12] = float("-inf")
    x[12:16] = -1e10
    before = tk.launches
    vk, ik = tk.row_topk(x, k)
    vp, ip = tk.row_topk_plain(x, k)
    assert tk.launches == before + 1
    assert torch.equal(vk, vp) and torch.equal(ik, ip)


@pytest.mark.cuda
def test_cuda_row_topk_routes(cuda_dev):
    """k <= 16 launches the row kernel, 16 < k <= 64 over wide enough rows
    the chunked kernel, anything else the counted stable sort; each equals
    the stable sort (over the clamped row on the chunked route)."""
    x = torch.randn((40, 8571), device=cuda_dev)
    x[:4, :300] = float("-inf")
    for k, route in ((15, "row_topk"), (32, "chunked_topk"), (34, "sort"),
                     (40, "sort"), (65, "sort")):
        n = (tk.launches, ck.launches, ot.sort_calls)
        v, i = ot.row_topk(x, k)
        grew = tuple(b - a for a, b in zip(
            n, (tk.launches, ck.launches, ot.sort_calls)))
        assert grew == {"row_topk": (1, 0, 0), "chunked_topk": (0, 1, 0),
                        "sort": (0, 0, 1)}[route], k
        plain = (ck.chunked_topk_plain if route == "chunked_topk"
                 else tk.row_topk_plain)
        pv, pi = plain(x, k)
        assert torch.equal(v, pv) and torch.equal(i, pi)
    with pytest.raises(ValueError, match="domain"):
        ck.chunked_topk(torch.zeros((2, 4000), device=cuda_dev), 17)


@pytest.mark.cuda
@pytest.mark.parametrize("b,d,h,maxout", [(250, 1024, 512, True),
                                          (50, 512, 256, False),
                                          (750, 1024, 512, False),
                                          (50, 1024, 512, True),
                                          (3, 100, 60, False),
                                          (3, 100, 60, True),
                                          (5, 37, 50, True)])
def test_cuda_lstm_cell_matches_plain(cuda_dev, b, d, h, maxout):
    """The ragged shapes: D+H (160, 87) does not divide into the cluster's
    K slices and H (60, 50) not by the tile width; D = 37 takes the 4-byte
    copies."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda_dev).manual_seed(b + d)
    n = 5 if maxout else 4
    w = (torch.rand((d + h, n * h), generator=g, device=cuda_dev) - 0.5) / 8
    bias = (torch.rand((n * h,), generator=g, device=cuda_dev) - 0.5) / 8
    x, h0, c0 = (torch.randn((b, m), generator=g, device=cuda_dev)
                 for m in (d, h, h))
    before = lk.launches
    hk, ck = lk.lstm_cell(w, bias, x, h0, c0, maxout=maxout)
    hp, cp = lk.lstm_cell_plain(w, bias, x, h0, c0, maxout=maxout)
    assert lk.launches == before + 1
    # f32 sums in another order than cuBLAS; TF32 off
    torch.testing.assert_close(hk, hp, atol=1e-4, rtol=0)
    torch.testing.assert_close(ck, cp, atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("mix", [("f32", "f32", "bf16"),
                                 ("bf16", "f32", "bf16"),
                                 ("bf16", "bf16", "bf16"),
                                 ("f32", "bf16", "bf16")], ids="/".join)
@pytest.mark.parametrize("b,d,h,maxout", [(50, 1024, 512, True),
                                          (150, 1024, 512, True),
                                          (50, 512, 256, False),
                                          (50, 1024, 512, False),
                                          (3, 100, 60, True),
                                          (5, 37, 50, True)])
def test_cuda_lstm_cell_bf16_matches_plain(cuda_dev, b, d, h, maxout, mix):
    """The bf16 entries (ROADMAP A15): x / (w, b) / (h, c) each f32 or
    bf16, converted as loaded, the f32 core, h' and c' rounded to h's
    type; rtol = atol = 1e-2 (a sum in another order may round to the
    neighbouring bf16)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}
    g = torch.Generator(device=cuda_dev).manual_seed(b + d + 1)
    n = 5 if maxout else 4
    w = ((torch.rand((d + h, n * h), generator=g, device=cuda_dev) - 0.5)
         / 8).to(dt[mix[1]])
    bias = ((torch.rand((n * h,), generator=g, device=cuda_dev) - 0.5)
            / 8).to(dt[mix[1]])
    x = torch.randn((b, d), generator=g, device=cuda_dev).to(dt[mix[0]])
    h0, c0 = (torch.randn((b, h), generator=g, device=cuda_dev).to(
        dt[mix[2]]) for _ in range(2))
    before, before_bf = lk.launches, lk.bf16_launches
    hk, ck = lk.lstm_cell(w, bias, x, h0, c0, maxout=maxout)
    hp, cp = lk.lstm_cell_plain(w, bias, x, h0, c0, maxout=maxout)
    assert (lk.launches, lk.bf16_launches) == (before + 1, before_bf + 1)
    assert hk.dtype == hp.dtype == dt[mix[2]]
    torch.testing.assert_close(hk.float(), hp.float(), atol=1e-2, rtol=1e-2)
    torch.testing.assert_close(ck.float(), cp.float(), atol=1e-2, rtol=1e-2)
    with pytest.raises(ValueError, match="mixture"):
        lk.lstm_cell(w, bias.double(), x, h0, c0, maxout=maxout)


@pytest.mark.cuda
@pytest.mark.parametrize("b,d,h,tile", [(50, 100, 76, dict(bn=16, cluster=4)),
                                        (600, 100, 300,
                                         dict(bn=32, cluster=2))])
def test_cuda_lstm_cell_plans(cuda_dev, b, d, h, tile):
    """The small batches split K across a cluster of up to 8, the large ones
    take the wide tile and a smaller cluster; each tile width, with its
    cluster and without, computes the same cell, with the same bits on a
    rerun."""
    assert lk.plan(50, 512, 256)["cluster"] == 8
    assert lk.plan(50, 1024, 512)["cluster"] == 8
    assert lk.plan(250, 1024, 512) == dict(bn=16, cluster=8, k_rows=192,
                                           blocks=1024)
    assert lk.plan(750, 1024, 512) == dict(bn=32, cluster=2, k_rows=768,
                                           blocks=384)
    pl = lk.plan(b, d, h)
    assert {k: pl[k] for k in tile} == tile
    g = torch.Generator(device=cuda_dev).manual_seed(7)
    w = (torch.rand((d + h, 5 * h), generator=g, device=cuda_dev) - 0.5) / 8
    bias = (torch.rand((5 * h,), generator=g, device=cuda_dev) - 0.5) / 8
    x, h0, c0 = (torch.randn((b, m), generator=g, device=cuda_dev)
                 for m in (d, h, h))
    hp, cp = lk.lstm_cell_plain(w, bias, x, h0, c0, maxout=True)
    hk, ck = lk.lstm_cell(w, bias, x, h0, c0, maxout=True)
    torch.testing.assert_close(hk, hp, atol=1e-4, rtol=0)
    torch.testing.assert_close(ck, cp, atol=1e-4, rtol=0)
    again = lk.lstm_cell(w, bias, x, h0, c0, maxout=True)
    assert torch.equal(again[0], hk) and torch.equal(again[1], ck)
    hu, cu = torch.empty_like(h0), torch.empty_like(c0)
    err = build.load().lstm_cell_f32_unclustered(
        x.data_ptr(), h0.data_ptr(), c0.data_ptr(), w.data_ptr(),
        bias.data_ptr(), hu.data_ptr(), cu.data_ptr(), b, d, h, 5,
        torch.cuda.current_stream(cuda_dev).cuda_stream)
    build.check(err, "lstm_cell_f32_unclustered")
    torch.testing.assert_close(hu, hp, atol=1e-4, rtol=0)
    torch.testing.assert_close(cu, cp, atol=1e-4, rtol=0)
