"""Attention weight transforms (counterpart of
`unpaired_image_captioning_tpu/ops/attention_transforms.py`).

Only `softmax` is ported; sparsemax and the constrained (fertility)
transforms are ROADMAP A11. Functions take logits `z` [..., N] and an
optional 0/1 `mask` over the last axis.
"""

from __future__ import annotations

import torch

NEG = -1e9


def softmax(z: torch.Tensor, mask=None, upper_bounds=None) -> torch.Tensor:
    """Masked positions are set to -1e9 before the softmax."""
    del upper_bounds
    if mask is not None:
        z = torch.where(mask > 0, z, torch.full_like(z, NEG))
    return torch.softmax(z, dim=-1)


TRANSFORMS = {"softmax": softmax}
