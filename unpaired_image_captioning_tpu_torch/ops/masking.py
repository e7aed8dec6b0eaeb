"""Masking utilities (counterpart of
`unpaired_image_captioning_tpu/ops/masking.py`)."""

from __future__ import annotations

import torch


def length_mask(lengths: torch.Tensor, max_len: int,
                dtype=torch.float32) -> torch.Tensor:
    """[B] lengths -> [B, max_len] 0/1 mask."""
    pos = torch.arange(max_len, device=lengths.device)[None, :]
    return (pos < lengths[:, None]).to(dtype)


def seq_mask_from_labels(labels: torch.Tensor, include_first_eos: bool = True,
                         dtype=torch.float32) -> torch.Tensor:
    """Caption label tensor [B, T] (0 = pad/eos) -> loss mask [B, T].

    The reference builds masks with a 1 at the first EOS slot as well
    (dataloader.py get_batch: mask covers len+2 with the implicit eos), so
    `include_first_eos=True` shifts a 1 past the last nonzero token.
    """
    nonzero = labels > 0
    if not include_first_eos:
        return nonzero.to(dtype)
    # mask[t] = 1 if labels[t] != 0 or labels[t-1] != 0  (first EOS kept)
    prev = torch.cat([torch.ones_like(nonzero[:, :1]), nonzero[:, :-1]], 1)
    return (nonzero | prev).to(dtype)


def masked_softmax(logits: torch.Tensor, mask, dim: int = -1) -> torch.Tensor:
    """Softmax with a multiplicative 0/1 mask and renormalization: softmax
    first, multiply by the mask, renormalize. NOT -inf masking, so padded
    attention slots behave as in the reference."""
    weight = torch.exp(logits - logits.amax(dim=dim, keepdim=True))
    if mask is not None:
        weight = weight * mask
    denom = weight.sum(dim=dim, keepdim=True)
    return weight / torch.clamp(denom, min=1e-9)
