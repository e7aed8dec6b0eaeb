"""Row-wise top-k for beam selection (counterpart of
`unpaired_image_captioning_tpu/ops/topk.py`).

Tie semantics match `jax.lax.top_k` exactly: values descending, ties broken
by the LOWEST index first. Beam-search token identity with the reference
depends on it. NaN ranks above +inf, NaN among NaN by index, as both
`lax.top_k` and the stable sort rank a positive NaN; -0 ties with +0 and a
negative NaN ranks as NaN (there `lax.top_k`'s total order differs, off
the beam path). Both kernels return exactly what the stable sort returns.
`row_topk` routes a CUDA tensor by `topk_route`, as the JAX package's
`row_topk` routes a TPU array (`topk.py:321-332`):

- k <= 16: the exact row kernel (`kernels/row_topk.py`);
- 16 < k <= 64 and 2 * k * 128 <= V: the chunked kernel
  (`kernels/chunked_topk.py`), which, as the TPU route does, clamps the
  row to the finite range first;
- anything else: a stable descending sort, the counterpart of the XLA
  `lax.top_k` that the JAX package runs there, on the TPU too. `sort_calls`
  counts these calls on the card.

CPU tensors take the stable sort, as the JAX package off the TPU takes
`lax.top_k`. `sorted_topk` is that stable sort on any device; it serves
the small merges that the JAX package left to XLA's `lax.top_k`.

Returns (values [R, k] f32, indices [R, k] int64).
"""

from __future__ import annotations

import torch

from ..kernels import chunked_topk as ck
from ..kernels import row_topk as rk

sorted_topk = rk.row_topk_plain

sort_calls = 0


def topk_route(k: int, v: int) -> str:
    """The route of a CUDA top-k of k over rows of v: "row_topk",
    "chunked_topk" or "sort"."""
    if 1 <= k <= rk.MAX_K:
        return "row_topk"
    if ck.in_domain(k, v):
        return "chunked_topk"
    return "sort"


def row_topk(x: torch.Tensor, k: int):
    """Top-k along the last axis of a 2-D f32 tensor, `lax.top_k` order."""
    global sort_calls
    if x.device.type == "cpu":
        return sorted_topk(x, k)
    route = topk_route(k, x.shape[-1])
    if route == "row_topk":
        return rk.row_topk(x, k)
    if route == "chunked_topk":
        return ck.chunked_topk(x, k)
    sort_calls += 1
    return sorted_topk(x, k)


__all__ = ["row_topk", "sorted_topk", "topk_route"]
