"""PyTorch port, beam top-k on rows with NaN, +-inf, ties and fewer than k
finite values (`kernels/row_topk.py`, `kernels/chunked_topk.py`, both
`csrc/topk_select.cu`).

- On the CPU: each plain version against `jax.lax.top_k` (the chunked one
  over the JAX route's own clamp, `jnp.clip` to the finite range), on rows
  with NaN (NaN ranks above +inf, NaN among NaN by index), +-inf, all-equal
  values, all NaN, and fewer than k non-NaN values. Exact: indices equal,
  values equal with NaN where NaN.
- On a card (`cuda` marker): both kernels against their plain versions on
  those rows at the beam paths' shapes, at k = 1, 2, 16, 17 and 64 on rows
  whose starts fall on every 4-byte offset of a 16-byte line (V % 4 in
  {0, 1, 2, 3}), at row counts on both sides of the launch's block-size
  choice, and on rows too long to stage in shared memory. On a card
  machine without jax, run them with

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_topk_select.py
"""

import ctypes

import numpy as np
import pytest
import torch

from unpaired_image_captioning_tpu_torch.kernels import build
from unpaired_image_captioning_tpu_torch.kernels import chunked_topk as ck
from unpaired_image_captioning_tpu_torch.kernels import row_topk as tk

torch.set_num_threads(1)

F32_MIN = np.finfo(np.float32).min
F32_MAX = np.finfo(np.float32).max
# rows built for the order's edges (positive NaN: np.nan's sign)
KINDS = ("nan", "nan_inf", "all_equal", "all_nan", "few_finite",
         "few_real", "inf_ties", "ties")


def _special(kind: str, v: int, k: int, rs) -> np.ndarray:
    x = rs.randn(v).astype(np.float32)
    if kind == "nan":
        x[rs.rand(v) < 0.02] = np.nan
    elif kind == "nan_inf":
        x[rs.choice(v, 3 * k, replace=False)] = np.inf
        x[rs.choice(v, 2 * k, replace=False)] = -np.inf
        x[rs.choice(v, k // 2 + 1, replace=False)] = np.nan
    elif kind == "all_equal":
        x[:] = 3.0
    elif kind == "all_nan":
        x[:] = np.nan
    elif kind == "few_finite":
        # fewer than k values that are not NaN: the NaN fill the top k
        x[:] = np.nan
        x[rs.choice(v, max(k // 2, 1) - 1, replace=False)] = 1.0
    elif kind == "few_real":
        # fewer than k finite values, the rest -inf (a dead beam's row)
        x[:] = -np.inf
        x[rs.choice(v, k - 1, replace=False)] = rs.randn(k - 1)
    elif kind == "inf_ties":
        x[:] = -1e10
        x[rs.choice(v, 2 * k, replace=False)] = np.inf
        x[7] = F32_MAX                  # ties +inf once clamped
    elif kind == "ties":
        x = np.round(x * 2) / 2 + 0.0   # no -0: lax.top_k ranks it below +0
    return x.astype(np.float32)


def _rows(v: int, k: int, seed: int) -> np.ndarray:
    rs = np.random.RandomState(seed)
    return np.stack([_special(kind, v, k, rs) for kind in KINDS])


def _jax_pair(jv, ji):
    """lax.top_k's (values, indices) as torch tensors (int64 indices)."""
    return (torch.from_numpy(np.array(jv)),
            torch.from_numpy(np.array(ji)).long())


def _same(got, want) -> bool:
    """Indices equal; values equal, NaN where NaN."""
    (gv, gi), (wv, wi) = got, want
    nan = torch.isnan(wv)
    return (torch.equal(gi, wi) and torch.equal(torch.isnan(gv), nan)
            and torch.equal(torch.where(nan, 0.0, gv),
                            torch.where(nan, 0.0, wv)))


@pytest.mark.parametrize("k", [1, 2, 5, 16])
def test_row_plain_matches_lax_top_k(k):
    import jax

    x = _rows(1100, k, seed=k)
    jv, ji = jax.lax.top_k(x, k)
    got = tk.row_topk_plain(torch.from_numpy(x), k)
    assert _same(got, _jax_pair(jv, ji))


@pytest.mark.parametrize("k", [17, 32, 64])
def test_chunked_plain_matches_the_routes_clamp_and_lax_top_k(k):
    import jax
    import jax.numpy as jnp

    x = _rows(2 * k * 128 + 37, k, seed=k)
    # the JAX route's clamp (ops/topk.py::_chunked_topk): NaN stays NaN
    xc = jnp.clip(jnp.asarray(x), F32_MIN, F32_MAX)
    jv, ji = jax.lax.top_k(xc, k)
    got = ck.chunked_topk_plain(torch.from_numpy(x), k)
    assert _same(got, _jax_pair(jv, ji))
    assert not np.isinf(got[0].numpy()).any()


def test_nan_order_on_the_issue_row():
    """NaN above +inf and above 3, NaN among NaN by index."""
    x = torch.tensor([[1.0, float("nan"), 3.0, float("-inf"), 2.0,
                       float("nan")]])
    v, i = tk.row_topk_plain(x, 3)
    assert i.tolist() == [[1, 5, 2]] and v[0, 2] == 3.0
    v, i = ck.chunked_topk_plain(x, 6)
    assert i.tolist() == [[1, 5, 2, 4, 0, 3]] and v[0, 5] == F32_MIN


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _card_rows(dev, r, v, k, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((r, v), generator=g, device=dev)
    special = torch.from_numpy(_rows(v, k, seed)).to(dev)
    n = min(r, len(KINDS))
    x[:n] = special[:n]
    return x


def _kernel_and_plain(k):
    if k <= tk.MAX_K:
        return tk, tk.row_topk, tk.row_topk_plain
    return ck, ck.chunked_topk, ck.chunked_topk_plain


@pytest.mark.cuda
@pytest.mark.parametrize("r,v,k", [(250, 9488, 5), (750, 8571, 15),
                                   (1000, 9488, 20), (1600, 8571, 32),
                                   (256, 16384, 64)])
def test_cuda_topk_special_rows_at_path_shapes(cuda_dev, r, v, k):
    x = _card_rows(cuda_dev, r, v, k, seed=k)
    mod, kernel, plain = _kernel_and_plain(k)
    before = mod.launches
    got = kernel(x, k)
    assert mod.launches == before + 1
    assert _same(got, plain(x, k))


@pytest.mark.cuda
@pytest.mark.parametrize("vmod", [0, 1, 2, 3])
@pytest.mark.parametrize("k", [1, 2, 16, 17, 64])
def test_cuda_topk_row_alignment(cuda_dev, k, vmod):
    """Rows of V = 16,384 + vmod: with vmod odd the row starts walk through
    every 4-byte offset of a 16-byte line (the staging copy's scalar head
    and tail), with vmod 2 through two of them."""
    x = _card_rows(cuda_dev, 37, 16384 + vmod, k, seed=vmod)
    _, kernel, plain = _kernel_and_plain(k)
    assert _same(kernel(x, k), plain(x, k))


@pytest.mark.cuda
@pytest.mark.parametrize("r", [37, 300])
@pytest.mark.parametrize("k", [3, 16, 33, 64])
def test_cuda_topk_every_block_size(cuda_dev, r, k):
    """The launch takes 512 threads a row up to two rows an SM and 256
    above (132 SMs on an H100: 37 rows take 512, 300 take 256); both
    instances, through each entry, equal the plain version."""
    x = _card_rows(cuda_dev, r, 16391, k, seed=r + k)
    _, kernel, plain = _kernel_and_plain(k)
    assert _same(kernel(x, k), plain(x, k))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [16, 64])
def test_cuda_topk_rows_too_long_to_stage(cuda_dev, k):
    """Rows past the staging limit (200 KB) are read from device memory in
    every pass; the result is the same."""
    x = _card_rows(cuda_dev, 12, 60001, k, seed=k)
    _, kernel, plain = _kernel_and_plain(k)
    assert _same(kernel(x, k), plain(x, k))


@pytest.mark.cuda
def test_cuda_topk_rejects_k_outside_its_entry(cuda_dev):
    x = torch.randn((4, 300), device=cuda_dev)
    stream = torch.cuda.current_stream(cuda_dev).cuda_stream
    out = torch.empty((4, 65), device=cuda_dev)
    idx = torch.empty((4, 65), dtype=torch.int64, device=cuda_dev)
    lib = build.load()
    for name, k in (("row_topk_f32", 17), ("chunked_topk_f32", 65)):
        err = getattr(lib, name)(x.data_ptr(), out.data_ptr(), idx.data_ptr(),
                                 4, 300, k, ctypes.c_void_p(stream))
        assert err != 0


@pytest.mark.cuda
@pytest.mark.parametrize("k", [5, 15, 32])
def test_cuda_topk_rows_of_ties_repeatedly(cuda_dev, k):
    """Rows whose k-th key carries more than 256 ties (a dead beam's -inf
    or -1e10 row, an all-equal row) take the tie pass; 300 launches in a
    row, each equal to the plain version (a block whose threads disagree
    on the gathered count would leave its barriers unmatched)."""
    g = torch.Generator(device=cuda_dev).manual_seed(k)
    x = torch.randn((750, 8571), generator=g, device=cuda_dev)
    x[::3] = float("-inf")
    x[1::3] = -1e10
    x[2::6] = 0.5
    x[::3, 7:7 + k // 2] = 1.0
    mod, kernel, plain = _kernel_and_plain(k)
    want = plain(x, k)
    for _ in range(300):
        assert _same(kernel(x, k), want)
