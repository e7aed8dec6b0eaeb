"""SCST (self-critical sequence training) rewards on the device
(counterpart of `unpaired_image_captioning_tpu/losses/rewards.py`).

Reference `misc/rewards.py:37-81`: a greedy baseline decode, reward =
cider_reward_weight * CIDEr-D + bleu_reward_weight * BLEU-4 against the
image's ground-truth captions (`gts`), advantage = reward(sample) -
reward(greedy), repeated over the time steps. The sequences never leave
the device: the n-gram scoring is `ops/cider.py` over the prepro_ngrams df
table (the reference stringifies the ids and scores on the host).
"""

from __future__ import annotations

import torch

from ..ops.cider import DfTable, bleu4, cider_d


def compute_reward(seq: torch.Tensor, gts: torch.Tensor,
                   gts_mask: torch.Tensor, table: DfTable, *,
                   cider_weight: float = 1.0,
                   bleu_weight: float = 0.0) -> torch.Tensor:
    """seq: [B, T] sampled or greedy ids; gts: [B, R, Tg]; gts_mask: [B, R].
    Returns [B] float32."""
    r = torch.zeros((seq.shape[0],), dtype=torch.float32, device=seq.device)
    if cider_weight != 0.0:
        r = r + cider_weight * cider_d(seq, gts, gts_mask, table)
    if bleu_weight != 0.0:
        r = r + bleu_weight * bleu4(seq, gts, gts_mask)
    return r


def get_self_critical_reward(sample_seq: torch.Tensor,
                             greedy_seq: torch.Tensor, gts: torch.Tensor,
                             gts_mask: torch.Tensor, table: DfTable, *,
                             cider_weight: float = 1.0,
                             bleu_weight: float = 0.0):
    """Returns (the advantage [B, T] = reward(sample) - reward(greedy),
    repeated over time, and the samples' rewards [B])."""
    kw = dict(cider_weight=cider_weight, bleu_weight=bleu_weight)
    rs = compute_reward(sample_seq, gts, gts_mask, table, **kw)
    rg = compute_reward(greedy_seq, gts, gts_mask, table, **kw)
    adv = (rs - rg)[:, None].expand(sample_seq.shape)
    return adv.to(torch.float32), rs
