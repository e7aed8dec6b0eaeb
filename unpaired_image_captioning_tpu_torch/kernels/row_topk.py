"""Exact row top-k: the wrapper of `csrc/topk_select.cu`'s `row_topk_f32`
and its plain version.

Replaces the TPU kernels `unpaired_image_captioning_tpu/ops/topk.py
::_lane_topk_kernel` and `::_row_topk_kernel` (the lane kernel's exact
fallback). Order is `jax.lax.top_k`'s: values descending, ties to the
lowest index, so beam selection stays token-identical with the reference.
NaN ranks above +inf (NaN among NaN by index) and -0 ties with +0, as in
the plain version's stable sort; the kernel returns what it returns on
every row, NaN rows and rows with fewer than k finite values included.

`row_topk` runs the plain version for CPU tensors and launches the kernel
for CUDA tensors; it never routes a CUDA tensor to the plain version.
`launches` counts kernel launches.
"""

from __future__ import annotations

import torch

from . import build

MAX_K = 16   # the kernel's domain; larger k: `ops/topk.py::topk_route`

launches = 0


def row_topk_plain(x: torch.Tensor, k: int):
    """Plain version: a stable descending sort keeps equal values in index
    order, which is lax.top_k's tie rule, and puts NaN first, above +inf.
    (torch.topk makes no tie promise.) Returns (values [..., k], int64
    indices [..., k])."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def row_topk(x: torch.Tensor, k: int):
    """Top-k along the last axis of a 2-D f32 tensor, lax.top_k order."""
    global launches
    if x.device.type == "cpu":
        return row_topk_plain(x, k)
    if x.device.type != "cuda":
        raise ValueError(f"row_topk: unsupported device {x.device}")
    if x.dim() != 2 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("row_topk: x must be a contiguous 2-D f32 tensor, "
                         f"got {x.dtype} {tuple(x.shape)}")
    rows, v = x.shape
    if not 1 <= k <= MAX_K:
        raise ValueError(f"row_topk: k={k} is outside the kernel's 1..{MAX_K}"
                         "; ops/topk.py routes larger k")
    if k > v:
        raise ValueError(f"row_topk: k={k} exceeds the row length {v}")
    vals = torch.empty((rows, k), dtype=torch.float32, device=x.device)
    idx = torch.empty((rows, k), dtype=torch.int64, device=x.device)
    lib = build.load()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.row_topk_f32(x.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                           rows, v, k, stream)
    build.check(err, "row_topk_f32")
    launches += 1
    return vals, idx
