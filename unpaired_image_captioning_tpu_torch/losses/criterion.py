"""Training criteria (counterpart of
`unpaired_image_captioning_tpu/losses/criterion.py`).

Ported so far: `language_model_loss` (reference LanguageModelCriterion,
misc/criterion.py:138-159), including the sum over the stackcap heads. The
NMT NLL, label smoothing, KLD and Weight_Trans losses are ROADMAP A7.
"""

from __future__ import annotations

import torch


def language_model_loss(logprobs, targets: torch.Tensor,
                        masks: torch.Tensor) -> torch.Tensor:
    """Masked NLL over caption logprobs.

    logprobs: [B, T, V+1] log-softmax outputs (or a list of them, the
    stackcap heads, whose losses are summed); targets, masks: [B, T],
    already shifted (labels[:, 1:], masks[:, 1:]).
    """
    if isinstance(logprobs, (list, tuple)):
        return sum(language_model_loss(lp, targets, masks) for lp in logprobs)
    t = min(logprobs.shape[1], targets.shape[1])
    lp = logprobs[:, :t]
    tg = targets[:, :t].long()
    mk = masks[:, :t].to(torch.float32)
    nll = -torch.gather(lp, -1, tg[..., None])[..., 0]
    return (nll * mk).sum() / torch.clamp(mk.sum(), min=1.0)
