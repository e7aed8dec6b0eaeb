"""Training criteria (counterpart of
`unpaired_image_captioning_tpu/losses/criterion.py`).

- `language_model_loss`: the reference LanguageModelCriterion
  (misc/criterion.py:138-159), including the sum over the stackcap heads;
- `reward_loss`: the SCST RewardCriterion (:104-124), with the mask shift
  that counts the first EOS;
- `nmt_loss` with `NMTStats`: the NMT NLL with PAD weight 0 and its
  ppl / accuracy statistics (:126-205), optionally label-smoothed
  (`label_smoothing_loss`, misc/utils.py:289-320);
- `kld_loss`: KL(teacher || student) (:285-292);
- `weight_trans_loss`: the Weight_Trans / Weight_Trans_y embedding
  alignment MSE on joint-vocabulary rows (:294-434);
- `ref_exhaustion_loss`, `ref_coverage_loss` (onmt/Loss.py:186-205) and
  `attention_regularizers`: the attention-budget terms. As in the JAX
  package, the trainer calls none of them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import constants as C
from ..parallel.mesh import mean_share, global_sum


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
    return (nll * mk).sum() / torch.clamp(global_sum(mk.sum()), min=1.0)


def reward_loss(sample_logprobs: torch.Tensor, gen_seq: torch.Tensor,
                rewards: torch.Tensor) -> torch.Tensor:
    """SCST policy-gradient loss: -logprob x advantage x mask, over the
    mask's sum.

    sample_logprobs: [B, T], the logprob of each sampled token; gen_seq:
    [B, T] sampled ids (0 after EOS); rewards: the advantage, [B, T] or [B]
    (broadcast over T). The mask is (token > 0) shifted right by one with a
    leading 1, so the step that emits the first EOS counts
    (criterion.py:113-116).
    """
    if rewards.dim() == 1:
        rewards = rewards[:, None] * torch.ones_like(sample_logprobs)
    nonzero = (gen_seq > 0).to(torch.float32)
    mask = torch.cat([torch.ones_like(nonzero[:, :1]), nonzero[:, :-1]], 1)
    out = -sample_logprobs * rewards * mask
    return out.sum() / torch.clamp(global_sum(mask.sum()), min=1.0)


class NMTStats(NamedTuple):
    """ppl / accuracy bookkeeping (the reference's Statistics): the summed
    loss, the non-PAD target tokens and the correct argmax predictions."""

    loss: torch.Tensor
    n_words: torch.Tensor
    n_correct: torch.Tensor

    def ppl(self) -> torch.Tensor:
        return torch.exp(torch.clamp(
            self.loss / torch.clamp(self.n_words, min=1), max=100.0))

    def accuracy(self) -> torch.Tensor:
        return 100.0 * self.n_correct / torch.clamp(self.n_words, min=1)

    def __add__(self, other: "NMTStats") -> "NMTStats":
        return NMTStats(self.loss + other.loss, self.n_words + other.n_words,
                        self.n_correct + other.n_correct)


def nmt_loss(logits: torch.Tensor, targets: torch.Tensor, *,
             label_smoothing: float = 0.0):
    """NLL with PAD weight 0 over generator outputs.

    logits: [B, T, V] (or [N, V]); targets: [B, T] (or [N]), PAD (0) tokens
    excluded. Returns (the mean loss per non-PAD token, NMTStats with the
    summed loss). The prediction is the first maximum of each row.
    """
    v = logits.shape[-1]
    lp = torch.log_softmax(logits.reshape(-1, v).to(torch.float32), dim=-1)
    tg = targets.reshape(-1).long()
    non_pad = (tg != C.PAD).to(torch.float32)
    if label_smoothing > 0.0:
        loss_tok = label_smoothing_loss(lp, tg, smoothing=label_smoothing)
    else:
        loss_tok = -torch.gather(lp, 1, tg[:, None])[:, 0]
    loss_sum = torch.sum(loss_tok * non_pad)
    pred = torch.argmax(lp, dim=-1)
    n_correct = torch.sum((pred == tg).to(torch.float32) * non_pad)
    n_words = global_sum(torch.sum(non_pad))
    stats = NMTStats(global_sum(loss_sum.detach()), n_words,
                     global_sum(n_correct))
    return loss_sum / torch.clamp(n_words, min=1.0), stats


def label_smoothing_loss(logprobs: torch.Tensor, targets: torch.Tensor, *,
                         smoothing: float = 0.1) -> torch.Tensor:
    """KL-based smoothed cross-entropy per token: logprobs [N, V], targets
    [N] -> [N]. The true distribution puts 1 - smoothing on the target,
    spreads smoothing over the V - 2 slots that are neither PAD nor the
    target, and 0 on PAD; the loss includes the t * log t term, and PAD
    targets contribute 0."""
    n, v = logprobs.shape
    confidence = 1.0 - smoothing
    true_dist = torch.full((n, v), smoothing / (v - 2), dtype=torch.float32,
                           device=logprobs.device)
    true_dist[:, C.PAD] = 0.0
    true_dist.scatter_(1, targets[:, None].long(), confidence)
    kl = torch.where(true_dist > 0,
                     true_dist * (torch.log(torch.clamp(true_dist, min=1e-20))
                                  - logprobs),
                     torch.zeros_like(logprobs))
    loss_tok = torch.sum(kl, dim=-1)
    return torch.where(targets == C.PAD, torch.zeros_like(loss_tok), loss_tok)


def kld_loss(logprobs_student: torch.Tensor,
             probs_teacher: torch.Tensor) -> torch.Tensor:
    """KL(teacher || student): the mean over rows of the sum over the last
    axis; the teacher is clamped at 1e-20 inside the log."""
    kl = probs_teacher * (torch.log(torch.clamp(probs_teacher, min=1e-20))
                          - logprobs_student)
    return mean_share(torch.sum(kl, dim=-1))


def ref_exhaustion_loss(upper_bounds_seq: torch.Tensor, *, shard_size: int,
                        lambda_exhaust: float) -> torch.Tensor:
    """The reference's exhaustion term (onmt/Loss.py:190-205, inside its
    shard loop): for each `shard_size` time shard, the upper bounds at the
    shard's last step without the <SINK> column, summed, so the value
    depends on the shard size. upper_bounds_seq: [B, T, S], each step's
    bounds after its attention was subtracted."""
    t = upper_bounds_seq.shape[1]
    last = [min(k + shard_size, t) - 1 for k in range(0, t, shard_size)]
    u = upper_bounds_seq[:, last, :-1]
    return lambda_exhaust * torch.sum(u)


def ref_coverage_loss(coverage_seq: torch.Tensor, attn_seq: torch.Tensor, *,
                      lambda_coverage: float) -> torch.Tensor:
    """The reference's coverage term (onmt/Loss.py:186-188): lambda x the
    sum of min(coverage_t, attn_t) over every step; upstream `attn_seq` is
    the copy attention (the term runs only with the copy loss).
    coverage_seq / attn_seq: [B, T, S]."""
    return lambda_coverage * torch.sum(
        torch.minimum(coverage_seq.float(), attn_seq.float()))


def attention_regularizers(attns: torch.Tensor, *, upper_bounds=None,
                           coverage=None, lambda_exhaust: float = 0.001,
                           lambda_coverage: float = 1.0) -> torch.Tensor:
    """Smoothed attention-budget penalties (the JAX package's own variants
    of the two terms above): the leftover fertility budget on the real
    source slots (all but <SINK>), and the attention mass past 1 a source
    slot, each averaged over the batch. attns: [B, T, S] (unused, as in
    JAX); upper_bounds / coverage: the final state's [B, S]."""
    del attns
    loss = torch.zeros((), dtype=torch.float32)
    if upper_bounds is not None and lambda_exhaust:
        leftover = torch.clamp_min(upper_bounds[:, :-1], 0.0)
        loss = loss.to(leftover.device) + lambda_exhaust * mean_share(
            leftover.sum(-1))
    if coverage is not None and lambda_coverage:
        over = torch.clamp_min(coverage - 1.0, 0.0)
        loss = loss.to(over.device) + lambda_coverage * mean_share(
            over.sum(-1))
    return loss


def weight_trans_loss(emb_a: torch.Tensor, emb_b: torch.Tensor,
                      align_a: torch.Tensor,
                      align_b: torch.Tensor) -> torch.Tensor:
    """Pivot embedding-alignment MSE: emb_a [Va, D] and emb_b [Vb, D] (for
    example the captioner's zh embedding and the NMT source embedding) at
    the J joint-vocabulary rows align_a / align_b [J]
    (`pivot.build_joint_vocab`)."""
    a = emb_a[align_a.long()].to(torch.float32)
    b = emb_b[align_b.long()].to(torch.float32)
    return torch.mean(torch.square(a - b))
