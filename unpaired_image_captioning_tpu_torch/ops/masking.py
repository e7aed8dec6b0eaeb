"""Masking utilities (counterpart of
`unpaired_image_captioning_tpu/ops/masking.py`)."""

from __future__ import annotations

import torch


def length_mask(lengths: torch.Tensor, max_len: int,
                dtype=torch.float32) -> torch.Tensor:
    """[B] lengths -> [B, max_len] 0/1 mask."""
    pos = torch.arange(max_len, device=lengths.device)[None, :]
    return (pos < lengths[:, None]).to(dtype)


def masked_softmax(logits: torch.Tensor, mask, dim: int = -1) -> torch.Tensor:
    """Softmax with a multiplicative 0/1 mask and renormalization: softmax
    first, multiply by the mask, renormalize. NOT -inf masking, so padded
    attention slots behave as in the reference."""
    weight = torch.exp(logits - logits.amax(dim=dim, keepdim=True))
    if mask is not None:
        weight = weight * mask
    denom = weight.sum(dim=dim, keepdim=True)
    return weight / torch.clamp(denom, min=1e-9)
