"""Additive attention: the plain versions of the three kernels of
`kernels/additive_attention.py` (counterpart of
`unpaired_image_captioning_tpu/ops/attention.py`).

    scores[n] = alpha . tanh(p_att[n] + q)          (no alpha_net bias)
    w = exp(scores - max(scores)) * mask;  w /= max(sum(w), 1e-9)
    out = sum_n w[n] * emb[n]

The alpha_net bias is dropped, as the TPU kernels drop it: a softmax is
shift-invariant, so it changes the result only by rounding. The mask is the
reference's multiply-then-renormalize, not a -inf mask, so a row whose mask
is all zeros comes out as zeros. The kernels compute these functions as
they are written here; the models' plain route (`models/att.py`, with the
bias) agrees with them to float tolerance.

Types (ROADMAP A15): as the TPU kernels, each version reads every operand
in its own type (f32 or bf16), computes the scores, the softmax and the
weighted sum in f32 (`.float()`), and returns the output in att_emb's
type. The decode step keeps att1, the lstm1 output and the att2 query in
f32 (the TPU kernel's VMEM values) and returns h1 and c1 in the carry's
types, att2 in att_emb's.
"""

from __future__ import annotations

import torch


def _softmax_renorm(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    scores = scores - scores.amax(dim=-1, keepdim=True)
    w = torch.exp(scores) * mask
    return w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)


def _attention_f32(p_att, att_h, alpha, mask, att_emb):
    """reference_attention's f32 result, before the output's rounding."""
    dot = torch.tanh(p_att.float() + att_h.float()[:, None, :])
    w = _softmax_renorm((dot @ alpha.float())[..., 0], mask.float())
    return torch.einsum("bn,bnd->bd", w, att_emb.float())


def reference_attention(p_att, att_h, alpha, mask, att_emb):
    """One query per image. p_att [B, N, A], att_h [B, A], alpha [A, 1],
    mask [B, N], att_emb [B, N, D] -> [B, D] in att_emb's type."""
    return _attention_f32(p_att, att_h, alpha, mask, att_emb).to(
        att_emb.dtype)


def reference_attention_beams(p_att, att_h, alpha, mask, att_emb):
    """K beam queries per image over its unexpanded memory. att_h
    [B, K, A] -> [B, K, D] in att_emb's type."""
    dot = torch.tanh(p_att.float()[:, None] + att_h.float()[:, :, None, :])
    w = _softmax_renorm((dot @ alpha.float())[..., 0],
                        mask.float()[:, None, :])
    return torch.einsum("bkn,bnd->bkd", w, att_emb.float()).to(att_emb.dtype)


def att_lstm_att_plain(p_att, att_emb, mask, q1, h0d, h1_prev, c1_prev, w1,
                       b1, emb2_w, emb2_b, h2att2_w, h2att2_b, alpha1,
                       alpha2):
    """The StackAtt / DenseAtt decode step between lstm0 and lstm2, as
    `_att_lstm_att_kernel` computes it: att1 with query q1, the maxout
    lstm1 on [h0d | att1 | h1_prev] (w1 [3H, 5H]), then att2 with query
    h2att2(h1 + emb2(att1)), both biases included. Returns (h1, c1, att2):
    h1 and c1 in h1_prev's and c1_prev's types, att2 in att_emb's; att1, h1
    inside the query and the query itself stay f32."""
    from ..kernels.lstm_cell import lstm_cell_plain

    att1 = _attention_f32(p_att, q1, alpha1, mask, att_emb)
    h1, c1 = lstm_cell_plain(w1, b1, torch.cat([h0d.float(), att1], -1),
                             h1_prev.float(), c1_prev.float(), maxout=True)
    q2 = ((h1 + att1 @ emb2_w.float() + emb2_b.float()) @ h2att2_w.float()
          + h2att2_b.float())
    return (h1.to(h1_prev.dtype), c1.to(c1_prev.dtype),
            reference_attention(p_att, q2, alpha2, mask, att_emb))
