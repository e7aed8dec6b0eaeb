"""Row-wise top-k for beam selection (counterpart of
`unpaired_image_captioning_tpu/ops/topk.py`).

Tie semantics match `jax.lax.top_k` exactly: values descending, ties broken
by the LOWEST index first. Beam-search token identity with the reference
depends on it. `row_topk` launches the exact CUDA kernel for CUDA tensors
(1 <= k <= 16) and runs a stable descending sort for CPU tensors.
`sorted_topk` is that stable sort on any device; it serves the small merges
that the JAX package left to XLA's `lax.top_k`.

Returns (values [R, k] f32, indices [R, k] int64).
"""

from __future__ import annotations

from ..kernels.row_topk import row_topk, row_topk_plain

sorted_topk = row_topk_plain

__all__ = ["row_topk", "sorted_topk"]
