"""Attention weight transforms: softmax, sparsemax and the constrained
(upper-bounded, fertility) variants (counterpart of
`unpaired_image_captioning_tpu/ops/attention_transforms.py`).

Functions take logits `z` [..., N], an optional 0/1 `mask` over the last
axis and, for the constrained ones, `upper_bounds` [..., N], and return a
probability vector on the simplex. Each is a composition of sorts, cumulative
sums, clips and fixed-count loops, so autograd differentiates it as JAX
differentiates the same composition. `matrix_tree_marginals` gives the edge
marginals of the matrix-tree structured attention.
"""

from __future__ import annotations

import math

import torch

NEG = -1e9


def _masked(z: torch.Tensor, mask) -> torch.Tensor:
    if mask is None:
        return z
    return torch.where(mask > 0, z, torch.full_like(z, NEG))


def softmax(z: torch.Tensor, mask=None, upper_bounds=None) -> torch.Tensor:
    """Masked positions are set to -1e9 before the softmax."""
    del upper_bounds
    return torch.softmax(_masked(z, mask), dim=-1)


def _simplex_threshold(z_sorted: torch.Tensor) -> torch.Tensor:
    """tau such that sum(max(z - tau, 0)) = 1 for descending-sorted z."""
    n = z_sorted.shape[-1]
    cssv = torch.cumsum(z_sorted, dim=-1) - 1.0
    rho_range = torch.arange(1, n + 1, dtype=z_sorted.dtype,
                             device=z_sorted.device)
    rho = (z_sorted * rho_range > cssv).sum(dim=-1)
    tau = torch.gather(cssv, -1, (rho - 1)[..., None])[..., 0]
    return tau / rho.to(z_sorted.dtype)


def sparsemax(z: torch.Tensor, mask=None, upper_bounds=None) -> torch.Tensor:
    """Euclidean projection of z onto the simplex (Martins & Astudillo
    2016)."""
    del upper_bounds
    z = _masked(z.float(), mask)
    z_sorted = torch.sort(z, dim=-1, descending=True).values
    tau = _simplex_threshold(z_sorted)
    return torch.maximum(z - tau[..., None], torch.zeros_like(z))


def constrained_softmax(z: torch.Tensor, mask=None,
                        upper_bounds=None) -> torch.Tensor:
    """Softmax with per-element upper bounds u (sum(u) >= 1 assumed): the
    softmax p scaled onto the free elements, the others clipped at their
    bound, by water-filling over max(4, ceil(log2 N)) rounds. Each round
    rescales the first softmax p, not the previous round's output."""
    if upper_bounds is None:
        return softmax(z, mask)
    z = _masked(z.float(), mask)
    p = torch.softmax(z, dim=-1)
    u = upper_bounds.float()
    zero = torch.zeros_like(p)
    free = torch.ones_like(p, dtype=torch.bool)
    out = p
    for _ in range(max(4, math.ceil(math.log2(max(z.shape[-1], 2))))):
        clipped = torch.where(free, zero, u)
        budget = 1.0 - clipped.sum(dim=-1, keepdim=True)
        mass = torch.where(free, p, zero).sum(dim=-1, keepdim=True)
        scaled = p * budget / torch.clamp_min(mass, 1e-20)
        out = torch.where(free, scaled, u)
        free = free & (scaled < u)
    return out


def constrained_sparsemax(z: torch.Tensor, mask=None,
                          upper_bounds=None) -> torch.Tensor:
    """Projection onto {p: 0 <= p <= u, sum p = 1}: 50 bisection steps on
    the threshold tau of p(tau) = clip(z - tau, 0, u), which is monotone
    in tau."""
    if upper_bounds is None:
        return sparsemax(z, mask)
    z = _masked(z.float(), mask)
    u = upper_bounds.float()
    zero = torch.zeros_like(z)

    def clip(x):
        return torch.minimum(torch.maximum(x, zero), u)

    lo = torch.amin(z - u, dim=-1) - 1.0
    hi = torch.amax(z, dim=-1)
    for _ in range(50):
        mid = 0.5 * (lo + hi)
        above = clip(z - mid[..., None]).sum(dim=-1) >= 1.0
        hi = torch.where(above, hi, mid)
        lo = torch.where(above, mid, lo)
    tau = 0.5 * (lo + hi)
    return clip(z - tau[..., None])


def matrix_tree_marginals(scores: torch.Tensor, root_scores: torch.Tensor):
    """Matrix-tree edge marginals of non-projective dependency attention
    (Koo et al. 2007; Liu & Lapata 2018): edge scores [B, N, N] (parent ->
    child) and root scores [B, N] -> (edge marginals [B, N, N], root
    marginals [B, N]) of the distribution over spanning trees. One batched
    f32 inverse of the Laplacian whose row 0 holds the root potentials."""
    n = scores.shape[-1]
    eye = torch.eye(n, dtype=scores.dtype, device=scores.device)
    a = torch.exp(scores - torch.amax(scores, dim=(-2, -1), keepdim=True))
    a = a * (1.0 - eye)[None]                      # no self-edges
    r = torch.exp(root_scores - torch.amax(root_scores, dim=-1,
                                           keepdim=True))
    col_sums = a.sum(dim=1)                        # [B, N]
    lap = -a + eye[None] * col_sums[:, None, :]
    lap = torch.cat([r[:, None, :], lap[:, 1:]], dim=1)
    binv = torch.linalg.inv(lap.float())           # B = L^-1
    diag_b = torch.diagonal(binv, dim1=1, dim2=2)  # B[m, m]
    not_first = (torch.arange(n, device=scores.device) != 0).float()
    # mu(h, m) = A[h, m] ([m != 0] B[m, m] - [h != 0] B[m, h])
    term1 = a * (diag_b * not_first)[:, None, :]
    term2 = a * binv.transpose(1, 2) * not_first[None, :, None]
    return term1 - term2, r * binv[:, :, 0]


TRANSFORMS = {
    "softmax": softmax,
    "sparsemax": sparsemax,
    "constrained_softmax": constrained_softmax,
    "constrained_sparsemax": constrained_sparsemax,
}
