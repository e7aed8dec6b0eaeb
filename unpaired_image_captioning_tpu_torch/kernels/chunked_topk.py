"""Exact row top-k for 16 < k <= 64 over the clamped row: the wrapper of
`csrc/topk_select.cu`'s `chunked_topk_f32` and its plain version.

Replaces the TPU kernel route `unpaired_image_captioning_tpu/ops/topk.py
::_chunked_topk` (the top k chunks by their maxima, then the iterative
`_row_topk_kernel` over the k * 128 candidates). That route first clamps
the row to the finite float range, so a selected -inf comes back as
-3.4028235e38 and a +inf as 3.4028235e38; both versions here return what it
returns. The clamp is `torch.clamp`'s: NaN stays NaN and ranks above every
number. Order is `jax.lax.top_k`'s over the clamped row: values
descending, ties to the lowest index (see `row_topk` for NaN and -0). The
domain is the route's: 16 < k <= 64 and 2 * k * 128 <= V (`topk.py:330`).
The kernel is B2's radix select with the clamp applied to each value as it
is keyed; it takes rows of any length.

`chunked_topk` runs the plain version for CPU tensors and launches the
kernel for CUDA tensors, raising outside the domain; it never routes a CUDA
tensor to the plain version. `launches` counts kernel launches.
"""

from __future__ import annotations

import torch

from . import build

CHUNK = 128
MIN_K, MAX_K = 17, 64

launches = 0

_F32 = torch.finfo(torch.float32)


def in_domain(k: int, v: int) -> bool:
    """The TPU route's condition (`topk.py:330`): 16 < k <= 64 and
    2 * k * 128 <= V."""
    return MIN_K <= k <= MAX_K and 2 * k * CHUNK <= v


def chunked_topk_plain(x: torch.Tensor, k: int):
    """Plain version: clamp to the finite range (NaN stays NaN), a stable
    descending sort (equal values stay in index order, NaN first), the
    first k. Returns (values [..., k], int64 indices [..., k])."""
    xc = torch.clamp(x, _F32.min, _F32.max)
    vals, idx = torch.sort(xc, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def chunked_topk(x: torch.Tensor, k: int):
    """Top-k along the last axis of a 2-D f32 tensor, over the clamped row
    in lax.top_k order."""
    global launches
    if x.device.type == "cpu":
        return chunked_topk_plain(x, k)
    if x.device.type != "cuda":
        raise ValueError(f"chunked_topk: unsupported device {x.device}")
    if x.dim() != 2 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("chunked_topk: x must be a contiguous 2-D f32 "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")
    rows, v = x.shape
    if not in_domain(k, v):
        raise ValueError(f"chunked_topk: k={k} over rows of {v} is outside "
                         f"the route's domain ({MIN_K} <= k <= {MAX_K} and "
                         f"2 * k * {CHUNK} <= V)")
    vals = torch.empty((rows, k), dtype=torch.float32, device=x.device)
    idx = torch.empty((rows, k), dtype=torch.int64, device=x.device)
    lib = build.load()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.chunked_topk_f32(x.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                               rows, v, k, stream)
    build.check(err, "chunked_topk_f32")
    launches += 1
    return vals, idx
