"""Attention-LSTM caption decoders: the `AttModel` base with the StackAtt
and DenseAtt cores (counterpart of
`unpaired_image_captioning_tpu/models/att.py`).

- word embedding with ReLU+dropout, `fc_embed` / `att_embed` MLPs, the
  attention memory pre-projected once per sequence (`ctx2att`);
- additive attention with softmax -> mask -> renormalize;
- StackAtt: three maxout LSTMs and two attentions per step; DenseAtt adds
  the two fusion layers.

States are batch-major `(h[B,L,H], c[B,L,H])` so beam search reorders them
along dim 0. Every LSTM step goes through `ops.rnn.lstm_step` (the fused
kernel on CUDA). The attentions are plain torch unless one of the four
module flags below, read at call time with the JAX package's defaults
(all off), routes them to the additive-attention kernels
(`kernels/additive_attention.py`): the device of the tensors then picks
the kernel (CUDA) or its plain version (CPU). The JAX package's TPU gates
(`jax.default_backend() == "tpu"`, widths % 128) have no counterpart. When
a gradient is taken, the plain single-query attention is an autograd
Function that keeps its inputs and its [B, N] softmax terms, and whose
backward, written out by hand, recomputes the [B, N, A] tanh once: as
under the JAX package's `jax.checkpoint`, that tensor is not kept for the
backward. The other caption families and `use_bn` BatchNorm are ROADMAP
A10.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..kernels import additive_attention as aak
from ..ops import rnn
from ..ops.masking import masked_softmax
from .base import (CaptionDecoder, Features, dropout, embedding_init,
                   init_embedding, init_module, linear, linear_init)


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------

def attention_init(rnn_size: int, att_hid_size: int, *,
                   device=None) -> nn.ModuleDict:
    return nn.ModuleDict({
        "h2att": linear_init(rnn_size, att_hid_size, device=device),
        "alpha_net": linear_init(att_hid_size, 1, device=device),
    })


# The kernel routes (`models/att.py:226-246` of the JAX package), off by
# default as there. STEP_FUSION: att1 -> lstm1 -> att2 of a Stack / Dense
# decode step as one `fused_att_lstm_att` call (decode only, expanded
# memory). BEAMS_KERNEL: the K-beam attention over unexpanded memory.
# SINGLE_KERNEL / TRAIN_KERNEL: the single-query attention outside / inside
# training.
STEP_FUSION = False
BEAMS_KERNEL = False
SINGLE_KERNEL = False
TRAIN_KERNEL = False


def _mask_or_ones(att_masks, p_att):
    if att_masks is not None:
        return att_masks.contiguous()
    return torch.ones(p_att.shape[:2], dtype=p_att.dtype, device=p_att.device)


def attention_apply(p: nn.ModuleDict, h, att_emb, p_att, att_masks,
                    training: bool = False):
    """Additive attention.

    h: [B*K, H] queries; att_emb: [B, N, D]; p_att: [B, N, A]; att_masks:
    [B, N] or None. When K > 1 (beam search with unexpanded memory) the
    memory is read once per image and broadcast over the K beams. Softmax
    over N, then multiplicative mask + renormalize (NOT -inf mask). The
    kernel routes drop the alpha_net bias (softmax shift invariance).
    """
    att_h = linear(p["h2att"], h)                                   # [BK,A]
    bq = h.shape[0]
    bm = p_att.shape[0]
    if bq != bm:
        k = bq // bm
        att_hk = att_h.reshape(bm, k, -1)
        if BEAMS_KERNEL:
            out = aak.additive_attention_beams(
                p_att.contiguous(), att_hk.contiguous(), p["alpha_net"].w,
                _mask_or_ones(att_masks, p_att), att_emb.contiguous())
            return out.reshape(bq, -1)
        dot = torch.tanh(p_att[:, None, :, :] + att_hk[:, :, None, :])  # [B,K,N,A]
        scores = linear(p["alpha_net"], dot)[..., 0]                  # [B,K,N]
        mask = att_masks[:, None, :] if att_masks is not None else None
        weight = masked_softmax(scores, mask)
        out = torch.einsum("bkn,bnd->bkd", weight, att_emb)
        return out.reshape(bq, -1)
    if TRAIN_KERNEL if training else SINGLE_KERNEL:
        return aak.additive_attention(
            p_att.contiguous(), att_h.contiguous(), p["alpha_net"].w,
            _mask_or_ones(att_masks, p_att), att_emb.contiguous())
    args = (p["alpha_net"].w, p["alpha_net"].b, p_att, att_h, att_masks,
            att_emb)
    if not torch.is_grad_enabled():
        return _attend(*args)
    return _RecomputedAttend.apply(*args)


def _attend(alpha_w, alpha_b, p_att, att_h, att_masks, att_emb):
    """The plain single-query attention: [B, N, A] tanh, scores, masked
    softmax, weighted sum."""
    dot = torch.tanh(p_att + att_h[:, None, :])                     # [B,N,A]
    scores = (dot @ alpha_w + alpha_b)[..., 0]                      # [B,N]
    weight = masked_softmax(scores, att_masks)
    return torch.einsum("bn,bnd->bd", weight, att_emb)


class _RecomputedAttend(torch.autograd.Function):
    """`_attend` keeping its inputs and its [B, N] softmax terms; the
    backward recomputes the tanh once and applies the chain rule directly,
    with no autograd graph, in the order autograd differentiates `_attend`
    (so the gradients round as the direct call's do). No dropout inside:
    the recompute is exact."""

    @staticmethod
    def forward(ctx, alpha_w, alpha_b, p_att, att_h, att_masks, att_emb):
        dot = torch.tanh(p_att + att_h[:, None, :])
        scores = (dot @ alpha_w + alpha_b)[..., 0]
        top = scores.amax(-1, keepdim=True)
        e = torch.exp(scores - top)
        e_m = e * att_masks if att_masks is not None else e
        denom = e_m.sum(-1, keepdim=True)
        weight = e_m / torch.clamp(denom, min=1e-9)
        ctx.save_for_backward(alpha_w, p_att, att_h, att_emb, att_masks, e,
                              denom, scores == top)
        return torch.einsum("bn,bnd->bd", weight, att_emb)

    @staticmethod
    def backward(ctx, g):
        (alpha_w, p_att, att_h, att_emb, masks, e, denom,
         at_max) = ctx.saved_tensors
        need = ctx.needs_input_grad
        e_m = e * masks if masks is not None else e
        dc = torch.clamp(denom, min=1e-9)
        weight = e_m / dc
        g_emb = weight[..., None] * g[:, None, :] if need[5] else None
        g_weight = torch.bmm(g[:, None, :], att_emb.transpose(1, 2))[:, 0]
        # weight = e_m / clamp(sum e_m); e_m = exp(scores - amax) * masks
        g_dc = (-g_weight * (weight / dc)).sum(-1, keepdim=True)
        g_e = g_weight / dc + g_dc * (denom >= 1e-9)
        if masks is not None:
            g_e = g_e * masks
        g_s = g_e * e
        g_s = g_s + (-g_s).sum(-1, keepdim=True) / at_max.sum(
            -1, keepdim=True) * at_max
        # scores = dot @ alpha_w + alpha_b, dot = tanh(p_att + att_h)
        b, n, a = p_att.shape
        g_col = g_s.reshape(b * n, 1)
        dot = torch.tanh(p_att + att_h[:, None, :])
        g_w = dot.reshape(b * n, a).t().mm(g_col) if need[0] else None
        g_b = g_s.sum().reshape(1) if need[1] else None
        g_pre = torch.ops.aten.tanh_backward(
            g_col.mm(alpha_w.t()).reshape(b, n, a), dot)
        g_h = g_pre.sum(1) if need[3] else None
        return (g_w, g_b, g_pre if need[2] else None, g_h, None, g_emb)


def _mlp_embed(p, x, rate, training, generator):
    return dropout(torch.relu(linear(p, x)), rate, training, generator)


# ---------------------------------------------------------------------------
# base
# ---------------------------------------------------------------------------

class AttModel(CaptionDecoder):
    def __init__(self, *, vocab_size: int, input_encoding_size: int,
                 rnn_size: int, num_layers: int, drop_prob_lm: float,
                 seq_length: int, fc_feat_size: int,
                 att_feat_size: int = 2048, att_hid_size: int = 512,
                 use_bn: int = 0, logit_layers: int = 1, device=None):
        super().__init__(vocab_size=vocab_size,
                         input_encoding_size=input_encoding_size,
                         rnn_size=rnn_size, num_layers=num_layers,
                         drop_prob_lm=drop_prob_lm, seq_length=seq_length,
                         fc_feat_size=fc_feat_size)
        if use_bn:
            raise NotImplementedError(
                "use_bn BatchNorm is not ported yet (ROADMAP A10)")
        self.att_feat_size = att_feat_size
        self.att_hid_size = att_hid_size
        self.logit_layers = logit_layers
        self.embed = embedding_init(vocab_size + 1, input_encoding_size,
                                    device=device)
        self.logit = self._logit_init(device)
        self.core = self.core_init(device)
        self.fc_embed = linear_init(fc_feat_size, rnn_size, device=device)
        self.att_embed = linear_init(att_feat_size, rnn_size, device=device)
        self.ctx2att = linear_init(rnn_size, att_hid_size, device=device)

    @property
    def eff_num_layers(self) -> int:
        return self.num_layers

    # ---- params ----
    def init_params(self, generator: torch.Generator) -> "AttModel":
        init_embedding(self.embed, generator)
        init_module(self, generator)
        return self

    def _logit_init(self, device) -> nn.ModuleList:
        v1 = self.vocab_size + 1
        layers = [linear_init(self.rnn_size, self.rnn_size, device=device)
                  for _ in range(self.logit_layers - 1)]
        layers.append(linear_init(self.rnn_size, v1, device=device))
        return nn.ModuleList(layers)

    def _logit(self, x, training, generator):
        for p in self.logit[:-1]:
            x = dropout(torch.relu(linear(p, x)), 0.5, training, generator)
        return linear(self.logit[-1], x)

    @property
    def beam_ctx_no_expand(self) -> tuple:
        # beams of one image share the attention memory: read once per
        # image per step instead of once per beam
        return ("att", "p_att", "masks")

    # ---- decode interface ----
    def make_decoder(self, feats: Features, *, training: bool = False,
                     generator: Optional[torch.Generator] = None):
        batch = feats.fc_feats.shape[0]
        fc_emb = _mlp_embed(self.fc_embed, feats.fc_feats, self.drop_prob_lm,
                            training, generator)
        att_emb = _mlp_embed(self.att_embed, feats.att_feats,
                             self.drop_prob_lm, training, generator)
        p_att = linear(self.ctx2att, att_emb)
        ctx = {"fc": fc_emb, "att": att_emb, "p_att": p_att,
               "masks": feats.att_masks}
        h0 = torch.zeros((batch, self.eff_num_layers, self.rnn_size),
                         dtype=feats.fc_feats.dtype,
                         device=feats.fc_feats.device)
        return ctx, (h0, h0)

    def step(self, ctx, state, it, *, training: bool = False,
             generator: Optional[torch.Generator] = None):
        h, state = self.step_core(ctx, state, it, training=training,
                                  generator=generator)
        return self.head(h, training=training, generator=generator), state

    def step_core(self, ctx, state, it, *, training: bool = False,
                  generator: Optional[torch.Generator] = None):
        xt = dropout(torch.relu(self.embed[it]), self.drop_prob_lm, training,
                     generator)
        return self.core_step(xt, ctx, state, training=training,
                              generator=generator)

    def head(self, h, *, training: bool = False,
             generator: Optional[torch.Generator] = None):
        logits = self._logit(h, training, generator)
        return torch.log_softmax(logits, dim=-1)

    # ---- to implement per family ----
    def core_init(self, device) -> nn.ModuleDict:
        raise NotImplementedError

    def core_step(self, xt, ctx, state, *, training, generator):
        raise NotImplementedError


# ---------------------------------------------------------------------------
# StackAtt / DenseAtt (3-LSTM stacks)
# ---------------------------------------------------------------------------

class StackAttModel(AttModel):
    @property
    def eff_num_layers(self) -> int:
        return 3

    def core_init(self, device) -> nn.ModuleDict:
        h = self.rnn_size
        e = self.input_encoding_size
        return nn.ModuleDict({
            "lstm0": rnn.init_lstm_params(e + h, h, maxout=True, device=device),
            "lstm1": rnn.init_lstm_params(2 * h, h, maxout=True, device=device),
            "lstm2": rnn.init_lstm_params(2 * h, h, maxout=True, device=device),
            "att1": attention_init(h, self.att_hid_size, device=device),
            "att2": attention_init(h, self.att_hid_size, device=device),
            "emb2": linear_init(h, h, device=device),
        })

    def _stack(self, p, xt, ctx, state, *, training, generator):
        h, c = state
        h0, c0 = rnn.lstm_step(p["lstm0"], torch.cat([xt, ctx["fc"]], -1),
                               h[:, 0], c[:, 0], maxout=True)
        h0d = dropout(h0, self.drop_prob_lm, training, generator)
        if self._can_fuse_stack(ctx, h0, training):
            # decode-path step fusion: att1 -> lstm1 -> att2 in one call
            q1 = linear(p["att1"]["h2att"], h0d)
            h1, c1, att2 = aak.fused_att_lstm_att(
                ctx["p_att"].contiguous(), ctx["att"].contiguous(),
                _mask_or_ones(ctx["masks"], ctx["p_att"]), q1,
                h0d.contiguous(), h[:, 1].contiguous(), c[:, 1].contiguous(),
                p["lstm1"].w, p["lstm1"].b, p["emb2"].w, p["emb2"].b,
                p["att2"]["h2att"].w, p["att2"]["h2att"].b,
                p["att1"]["alpha_net"].w, p["att2"]["alpha_net"].w)
            return h0d, h1, att2, (h0, h1), (c0, c1)
        att1 = attention_apply(p["att1"], h0d, ctx["att"], ctx["p_att"],
                               ctx["masks"], training=training)
        h1, c1 = rnn.lstm_step(p["lstm1"], torch.cat([h0d, att1], -1),
                               h[:, 1], c[:, 1], maxout=True)
        h1d = dropout(h1, self.drop_prob_lm, training, generator)
        att2 = attention_apply(p["att2"], h1d + linear(p["emb2"], att1),
                               ctx["att"], ctx["p_att"], ctx["masks"],
                               training=training)
        return h0d, h1d, att2, (h0, h1), (c0, c1)

    def _can_fuse_stack(self, ctx, h0, training: bool) -> bool:
        # decode only (dropout-free), expanded memory layout (K = 1)
        return (STEP_FUSION and not training
                and ctx["att"].shape[0] == h0.shape[0])

    def core_step(self, xt, ctx, state, *, training, generator):
        p = self.core
        h0d, h1d, att2, hs, cs = self._stack(p, xt, ctx, state,
                                             training=training,
                                             generator=generator)
        h, c = state
        h2, c2 = rnn.lstm_step(p["lstm2"], torch.cat([h1d, att2], -1),
                               h[:, 2], c[:, 2], maxout=True)
        out = dropout(h2, self.drop_prob_lm, training, generator)
        return out, (torch.stack([*hs, h2], 1), torch.stack([*cs, c2], 1))


class DenseAttModel(StackAttModel):
    def core_init(self, device) -> nn.ModuleDict:
        p = super().core_init(device)
        h = self.rnn_size
        p["fusion1"] = linear_init(2 * h, h, device=device)
        p["fusion2"] = linear_init(3 * h, h, device=device)
        return p

    def core_step(self, xt, ctx, state, *, training, generator):
        p = self.core
        h0d, h1d, att2, hs, cs = self._stack(p, xt, ctx, state,
                                             training=training,
                                             generator=generator)
        h, c = state
        fused01 = dropout(torch.relu(
            linear(p["fusion1"], torch.cat([h0d, h1d], -1))),
            self.drop_prob_lm, training, generator)
        h2, c2 = rnn.lstm_step(p["lstm2"], torch.cat([fused01, att2], -1),
                               h[:, 2], c[:, 2], maxout=True)
        h2d = dropout(h2, self.drop_prob_lm, training, generator)
        out = dropout(torch.relu(
            linear(p["fusion2"], torch.cat([h0d, h1d, h2d], -1))),
            self.drop_prob_lm, training, generator)
        return out, (torch.stack([*hs, h2], 1), torch.stack([*cs, c2], 1))
