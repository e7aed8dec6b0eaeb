"""Attention-LSTM caption decoders: the `AttModel` base and its cores
(counterpart of `unpaired_image_captioning_tpu/models/att.py`).

- word embedding with ReLU+dropout, `fc_embed` / `att_embed` MLPs with
  optional BatchNorm (`use_bn`), the attention memory pre-projected once
  per sequence (`ctx2att`);
- additive attention with softmax -> mask -> renormalize;
- cores: TopDown (two plain LSTMs), Att2in2 / Att2in / Att2all2 (one
  maxout cell whose gates take an attention term), AdaAtt / AdaAttMO (the
  visual-sentinel attention), StackAtt (three maxout LSTMs and two
  attentions), DenseAtt (StackAtt with two fusion layers) and
  ShowAttendTell (a stacked LSTM over [word; attention]);
- the wrappers' quirks: Att2in2 / Att2all2 use the raw fc feats
  (`fc_identity`), Att2in and ShowAttendTell attend over the raw att feats
  (`att_identity`) with a bare embedding (`embed_plain`).

States are batch-major `(h[B,L,H], c[B,L,H])` so beam search reorders them
along dim 0. The LSTM steps of TopDown, StackAtt, DenseAtt and
ShowAttendTell go through `ops.rnn.lstm_step` (the fused kernel on CUDA);
the Att2in family's and AdaAtt's cells add an attention term to their
gates, which the fused cell has no input for, so they are plain torch, as
they are XLA in the JAX package. The attentions are plain torch unless one
of the four module flags below, read at call time with the JAX package's
defaults (all off), routes them to the additive-attention kernels
(`kernels/additive_attention.py`): the device of the tensors then picks
the kernel (CUDA) or its plain version (CPU). The JAX package's TPU gates
(`jax.default_backend() == "tpu"`, widths % 128) have no counterpart. When
a gradient is taken, the plain single-query attention is an autograd
Function that keeps its inputs and its [B, N] softmax terms, and whose
backward, written out by hand, recomputes the [B, N, A] tanh once: as
under the JAX package's `jax.checkpoint`, that tensor is not kept for the
backward.

`use_bn` BatchNorm has torch's semantics: batch moments over the real
slots in training (the forward stashes them in `aux_out` for
`apply_bn_updates`), the running statistics at inference, and
`calibrate_batch_norm` to fill them from data. Its four tensors are
parameters, as they are leaves of the JAX parameter tree: the optimizer
holds state for them, an XE step gives `mean` / `var` a zero gradient, and
the SCST recompute (inference BatchNorm) a real one.
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
# decode step as one `fused_att_lstm_att` call (decode only without a
# gradient, expanded memory). BEAMS_KERNEL: the K-beam attention over
# unexpanded memory. SINGLE_KERNEL / TRAIN_KERNEL: the single-query
# attention outside / inside training.
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
# use_bn BatchNorm
# ---------------------------------------------------------------------------

BN_MOMENTUM = 0.1  # torch nn.BatchNorm1d's default
BN_EPS = 1e-5


class BatchNorm(nn.Module):
    """`scale`, `offset` and the running `mean` / `var` of one BatchNorm,
    all parameters (see the module's doc): fresh ones hold 1, 0, 0, 1."""

    def __init__(self, dim: int, *, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.empty((dim,), device=device))
        self.offset = nn.Parameter(torch.empty((dim,), device=device))
        self.mean = nn.Parameter(torch.empty((dim,), device=device))
        self.var = nn.Parameter(torch.empty((dim,), device=device))

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        for p, v in ((self.scale, 1.0), (self.offset, 0.0), (self.mean, 0.0),
                     (self.var, 1.0)):
            p.fill_(v)


def _masked_mean_var(x, mask):
    """Per-feature mean and biased variance over the real rows only (the
    reference feeds BN through pack_wrapper, so padded att slots never
    count). Returns (mean, var, n)."""
    flat = x.reshape(-1, x.shape[-1])
    if mask is None:
        n = torch.tensor(float(flat.shape[0]), device=x.device)
        mean = flat.mean(0)
        var = torch.square(flat - mean).mean(0)
    else:
        m = (mask.reshape(-1, 1) > 0).to(flat.dtype)
        n = torch.clamp(m.sum(), min=1.0)
        mean = (flat * m).sum(0) / n
        var = (torch.square(flat - mean) * m).sum(0) / n
    return mean, var, n


def batch_norm(p: BatchNorm, x, training: bool = True, *, mask=None,
               aux_out: Optional[dict] = None, key: Optional[str] = None):
    """BatchNorm: batch moments in training, the running statistics
    otherwise. In training, with `aux_out`, the detached batch moments go
    to `aux_out[key]` as (mean, unbiased var) for `apply_bn_updates` (the
    running variance takes the unbiased one, the normalisation the biased
    one)."""
    if training:
        mean, var, n = _masked_mean_var(x, mask)
        if aux_out is not None and key is not None:
            unbiased = var * (n / torch.clamp(n - 1.0, min=1.0))
            aux_out[key] = (mean.detach(), unbiased.detach())
    else:
        mean, var = p.mean, p.var
    norm = (x - mean) * torch.rsqrt(var + BN_EPS)
    return norm * p.scale + p.offset


@torch.no_grad()
def apply_bn_updates(model: nn.Module, bn_aux: dict,
                     momentum: float = BN_MOMENTUM) -> None:
    """Blend the batch moments a forward collected into the running
    statistics, in place: running = (1 - m) * running + m * batch.
    `bn_aux` maps "bn0" / "bn1" to (mean, unbiased var)."""
    for k, (mean, var) in bn_aux.items():
        p = getattr(model, k)
        p.mean.copy_((1.0 - momentum) * p.mean + momentum * mean)
        p.var.copy_((1.0 - momentum) * p.var + momentum * var)


@torch.no_grad()
def calibrate_batch_norm(model: nn.Module, loader, *, split: str = "train",
                         n_batches: int = 16) -> nn.Module:
    """Fill the `use_bn` running statistics from `n_batches` batches of
    `loader` (for converted checkpoints that lack tracked statistics), in
    place: bn0 from the real att slots, bn1 from the same rows through bn0
    and att_embed. A model without BatchNorm is left alone."""
    import numpy as np

    if not hasattr(model, "bn0"):
        return model
    rows = []
    for _ in range(n_batches):
        data = loader.get_batch(split)
        att = np.asarray(data["att_feats"], np.float32)
        rows.append(att[np.asarray(data["att_masks"]) > 0])
    flat = np.concatenate(rows, axis=0)
    dev = model.bn0.mean.device
    model.bn0.mean.copy_(torch.as_tensor(flat.mean(0), device=dev))
    model.bn0.var.copy_(torch.as_tensor(flat.var(0), device=dev))
    if hasattr(model, "bn1"):
        x = batch_norm(model.bn0, torch.as_tensor(flat, device=dev),
                       training=False)
        h = torch.relu(linear(model.att_embed, x))
        model.bn1.mean.copy_(h.mean(0))
        model.bn1.var.copy_(h.var(0, unbiased=False))
    return model


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
        self.att_feat_size = att_feat_size
        self.att_hid_size = att_hid_size
        self.use_bn = use_bn
        self.logit_layers = logit_layers
        self.embed = embedding_init(vocab_size + 1, input_encoding_size,
                                    device=device)
        self.logit = self._logit_init(device)
        self.core = self.core_init(device)
        if not self.fc_identity:
            self.fc_embed = linear_init(fc_feat_size, rnn_size, device=device)
        if not self.att_identity:
            self.att_embed = linear_init(att_feat_size, rnn_size,
                                         device=device)
            if use_bn:
                self.bn0 = BatchNorm(att_feat_size, device=device)
            if use_bn == 2:
                self.bn1 = BatchNorm(rnn_size, device=device)
        ctx_in = att_feat_size if self.att_identity else rnn_size
        self.ctx2att = linear_init(ctx_in, att_hid_size, device=device)
        self.extra_init(device)

    # ---- overridable structure knobs ----
    @property
    def eff_num_layers(self) -> int:
        return self.num_layers

    @property
    def fc_identity(self) -> bool:
        return False  # Att2in2 / Att2all2: the fc feats are used raw

    @property
    def att_identity(self) -> bool:
        return False  # Att2in / ShowAttendTell: attend over raw att feats

    @property
    def embed_plain(self) -> bool:
        return False  # Att2in / ShowAttendTell: bare embedding

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
                     generator: Optional[torch.Generator] = None,
                     aux_out: Optional[dict] = None):
        batch = feats.fc_feats.shape[0]
        if self.fc_identity:
            fc_emb = feats.fc_feats
        else:
            fc_emb = _mlp_embed(self.fc_embed, feats.fc_feats,
                                self.drop_prob_lm, training, generator)
        att = feats.att_feats
        if self.att_identity:
            att_emb = att
        else:
            if self.use_bn:
                att = batch_norm(self.bn0, att, training,
                                 mask=feats.att_masks, aux_out=aux_out,
                                 key="bn0")
            att_emb = _mlp_embed(self.att_embed, att, self.drop_prob_lm,
                                 training, generator)
            if self.use_bn == 2:
                att_emb = batch_norm(self.bn1, att_emb, training,
                                     mask=feats.att_masks, aux_out=aux_out,
                                     key="bn1")
        p_att = linear(self.ctx2att, att_emb)
        ctx = {"fc": fc_emb, "att": att_emb, "p_att": p_att,
               "masks": feats.att_masks}
        h0 = torch.zeros((batch, self.eff_num_layers, self.rnn_size),
                         dtype=feats.fc_feats.dtype,
                         device=feats.fc_feats.device)
        return ctx, (h0, h0)

    def step_core(self, ctx, state, it, *, training: bool = False,
                  generator: Optional[torch.Generator] = None):
        xt = self.embed[it]
        if not self.embed_plain:
            xt = dropout(torch.relu(xt), self.drop_prob_lm, training,
                         generator)
        return self.core_step(xt, ctx, state, training=training,
                              generator=generator)

    def head(self, h, *, training: bool = False,
             generator: Optional[torch.Generator] = None):
        logits = self._logit(h, training, generator)
        return torch.log_softmax(logits, dim=-1)

    # ---- to implement per family ----
    def extra_init(self, device) -> None:
        """Registers a family's parameters outside the base's tree."""

    def core_init(self, device) -> nn.ModuleDict:
        raise NotImplementedError

    def core_step(self, xt, ctx, state, *, training, generator):
        raise NotImplementedError


# ---------------------------------------------------------------------------
# TopDown (bottom-up / top-down, Anderson et al.)
# ---------------------------------------------------------------------------

class TopDownModel(AttModel):
    @property
    def eff_num_layers(self) -> int:
        return 2

    def core_init(self, device) -> nn.ModuleDict:
        h = self.rnn_size
        return nn.ModuleDict({
            "att_lstm": rnn.init_lstm_params(self.input_encoding_size + 2 * h,
                                             h, device=device),
            "lang_lstm": rnn.init_lstm_params(2 * h, h, device=device),
            "attention": attention_init(h, self.att_hid_size, device=device),
        })

    def core_step(self, xt, ctx, state, *, training, generator):
        p = self.core
        h, c = state
        att_in = torch.cat([h[:, 1], ctx["fc"], xt], -1)
        h_att, c_att = rnn.lstm_step(p["att_lstm"], att_in, h[:, 0], c[:, 0])
        att_res = attention_apply(p["attention"], h_att, ctx["att"],
                                  ctx["p_att"], ctx["masks"],
                                  training=training)
        h_lang, c_lang = rnn.lstm_step(p["lang_lstm"],
                                       torch.cat([att_res, h_att], -1),
                                       h[:, 1], c[:, 1])
        out = dropout(h_lang, self.drop_prob_lm, training, generator)
        return out, (torch.stack([h_att, h_lang], 1),
                     torch.stack([c_att, c_lang], 1))


# ---------------------------------------------------------------------------
# Att2in family (SCST paper)
# ---------------------------------------------------------------------------

def _maxout_gates_step(gates, prev_c, hsz: int):
    """The maxout cell's update from its 5H gates (i, f, o, m1, m2)."""
    sig = torch.sigmoid(gates[..., :3 * hsz])
    in_t = torch.maximum(gates[..., 3 * hsz:4 * hsz],
                         gates[..., 4 * hsz:5 * hsz])
    c_new = sig[..., hsz:2 * hsz] * prev_c + sig[..., :hsz] * in_t
    h_new = sig[..., 2 * hsz:3 * hsz] * torch.tanh(c_new)
    return h_new, c_new


class Att2in2Model(AttModel):
    """The attention enters the cell's maxout gates; raw fc feats (unused by
    the core)."""

    @property
    def eff_num_layers(self) -> int:
        return 1

    @property
    def fc_identity(self) -> bool:
        return True

    @property
    def _a2c_in(self) -> int:
        return self.rnn_size

    def core_init(self, device) -> nn.ModuleDict:
        h = self.rnn_size
        return nn.ModuleDict({
            # fused i2h + h2h 5H gates, maxout
            "cell": rnn.init_lstm_params(self.input_encoding_size, h,
                                         maxout=True, device=device),
            "a2c": linear_init(self._a2c_in, 2 * h, device=device),
            "attention": attention_init(h, self.att_hid_size, device=device),
        })

    def _gates(self, p, xt, prev_h, att_res):
        gates = torch.cat([xt, prev_h], -1) @ p["cell"].w + p["cell"].b
        # the attention term is added to the maxout (in_transform) chunks
        return torch.cat([gates[..., :3 * self.rnn_size],
                          gates[..., 3 * self.rnn_size:]
                          + linear(p["a2c"], att_res)], -1)

    def core_step(self, xt, ctx, state, *, training, generator):
        p = self.core
        h, c = state
        prev_h, prev_c = h[:, 0], c[:, 0]
        att_res = attention_apply(p["attention"], prev_h, ctx["att"],
                                  ctx["p_att"], ctx["masks"],
                                  training=training)
        h_new, c_new = _maxout_gates_step(self._gates(p, xt, prev_h, att_res),
                                          prev_c, self.rnn_size)
        out = dropout(h_new, self.drop_prob_lm, training, generator)
        return out, (h_new[:, None], c_new[:, None])


class Att2inModel(Att2in2Model):
    """The original att2in: bare embedding, raw att feats, `a2c` from
    att_feat_size."""

    @property
    def att_identity(self) -> bool:
        return True

    @property
    def embed_plain(self) -> bool:
        return True

    @property
    def _a2c_in(self) -> int:
        return self.att_feat_size


class Att2all2Model(Att2in2Model):
    """The attention is added to all five gates."""

    def core_init(self, device) -> nn.ModuleDict:
        h = self.rnn_size
        return nn.ModuleDict({
            "cell": rnn.init_lstm_params(self.input_encoding_size, h,
                                         maxout=True, device=device),
            "a2h": linear_init(h, 5 * h, device=device),
            "attention": attention_init(h, self.att_hid_size, device=device),
        })

    def _gates(self, p, xt, prev_h, att_res):
        gates = torch.cat([xt, prev_h], -1) @ p["cell"].w + p["cell"].b
        return gates + linear(p["a2h"], att_res)


# ---------------------------------------------------------------------------
# AdaAtt (adaptive attention with a visual sentinel)
# ---------------------------------------------------------------------------

class AdaAttModel(AttModel):
    use_maxout = False

    # (the unexpanded beam memory of AttModel: the sentinel attention is
    # k-aware, see core_step)

    def core_init(self, device) -> nn.ModuleDict:
        # the sentinel (input_encoding_size wide) is concatenated with the
        # rnn_size-wide att memory: the reference design needs them equal
        assert self.input_encoding_size == self.rnn_size, (
            "adaatt requires input_encoding_size == rnn_size")
        n_l = self.num_layers
        h = self.rnn_size
        e = self.input_encoding_size
        a = self.att_hid_size
        g = 5 if self.use_maxout else 4

        def lin(i, o):
            return linear_init(i, o, device=device)

        p = nn.ModuleDict({
            "w2h": lin(e, g * h), "v2h": lin(h, g * h),
            "h2h": nn.ModuleList([lin(h, g * h) for _ in range(n_l)]),
            "i2h": nn.ModuleList([lin(h, g * h) for _ in range(n_l - 1)]),
            "r_h2h": lin(h, h),
        })
        if n_l == 1:
            p["r_w2h"] = lin(e, h)
            p["r_v2h"] = lin(h, h)
        else:
            p["r_i2h"] = lin(h, h)
        p.update({"fr_linear": lin(h, e), "fr_embed": lin(e, a),
                  "ho_linear": lin(h, e), "ho_embed": lin(e, a),
                  "alpha_net": lin(a, 1), "att2h": lin(h, h)})
        return p

    def core_step(self, xt, ctx, state, *, training, generator):
        p = self.core
        n_l = self.num_layers
        hsz = self.rnn_size
        rate = self.drop_prob_lm
        h, c = state
        hs, cs = [], []
        fake_region = None
        x = xt
        for layer in range(n_l):
            prev_h, prev_c = h[:, layer], c[:, layer]
            if layer == 0:
                i2h = linear(p["w2h"], x) + linear(p["v2h"], ctx["fc"])
            else:
                x = dropout(hs[-1], rate, training, generator)
                i2h = linear(p["i2h"][layer - 1], x)
            gates = i2h + linear(p["h2h"][layer], prev_h)
            sig = torch.sigmoid(gates[..., :3 * hsz])
            if self.use_maxout:
                in_t = torch.maximum(gates[..., 3 * hsz:4 * hsz],
                                     gates[..., 4 * hsz:5 * hsz])
            else:
                in_t = torch.tanh(gates[..., 3 * hsz:4 * hsz])
            c_new = sig[..., hsz:2 * hsz] * prev_c + sig[..., :hsz] * in_t
            tanh_c = torch.tanh(c_new)
            h_new = sig[..., 2 * hsz:3 * hsz] * tanh_c
            if layer == n_l - 1:
                if layer == 0:
                    ri = linear(p["r_w2h"], x) + linear(p["r_v2h"], ctx["fc"])
                else:
                    ri = linear(p["r_i2h"], x)
                n5 = ri + linear(p["r_h2h"], prev_h)
                fake_region = torch.sigmoid(n5) * tanh_c
            hs.append(h_new)
            cs.append(c_new)
        # the JAX package's order of draws: top_h, the sentinel, then the
        # two attention heads, then the output
        top_h = dropout(hs[-1], rate, training, generator)
        fake_region = dropout(fake_region, rate, training, generator)

        # sentinel attention over [fake_region; att slots]
        fr = dropout(torch.relu(linear(p["fr_linear"], fake_region)), rate,
                     training, generator)
        fr_embed = linear(p["fr_embed"], fr)
        ho = dropout(torch.tanh(linear(p["ho_linear"], top_h)), rate,
                     training, generator)
        ho_embed = linear(p["ho_embed"], ho)
        # k-aware layout: the att memory, p_att and masks stay per image
        # [B, ...] under beam search while the sentinel and the query are
        # per beam [B*K, ...]; slot scores read the shared memory once per
        # image, the sentinel score is computed apart and put in front (the
        # reference's slot order). k == 1 is the expanded math.
        bm = ctx["att"].shape[0]
        k = ho.shape[0] // bm
        fr_k = fr.reshape(bm, k, -1)
        fr_ek = fr_embed.reshape(bm, k, -1)
        ho_ek = ho_embed.reshape(bm, k, -1)
        h_a = torch.tanh(ctx["p_att"][:, None] + ho_ek[:, :, None])
        slot_scores = linear(p["alpha_net"], h_a)[..., 0]          # [B,K,N]
        sent_score = linear(p["alpha_net"],
                            torch.tanh(fr_ek + ho_ek))[..., 0]      # [B,K]
        scores = torch.cat([sent_score[..., None], slot_scores], -1)
        masks = ctx["masks"]
        if masks is not None:
            masks = torch.cat([torch.ones_like(masks[:, :1]), masks],
                              1)[:, None, :]                       # [B,1,1+N]
        pi = masked_softmax(scores, masks)
        vis = (pi[..., :1] * fr_k
               + torch.einsum("bkn,bnd->bkd", pi[..., 1:], ctx["att"]))
        atten_out = vis.reshape(ho.shape[0], -1) + ho
        out = torch.tanh(linear(p["att2h"], atten_out))
        out = dropout(out, rate, training, generator)
        return out, (torch.stack(hs, 1), torch.stack(cs, 1))


class AdaAttMOModel(AdaAttModel):
    use_maxout = True


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
        # decode only (dropout-free), expanded memory layout (K = 1), and
        # no gradient: the fused kernel has no backward, so the SCST
        # recompute (forward(training=False) under grad) takes the unfused
        # route, which JAX differentiates
        return (STEP_FUSION and not training and not torch.is_grad_enabled()
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


# ---------------------------------------------------------------------------
# ShowAttendTell (the reference's legacy OldModel family)
# ---------------------------------------------------------------------------

class ShowAttendTellModel(AttModel):
    """Legacy show-attend-tell: the fc feats give the initial hidden state
    (h = c = img_linear(fc)); attention over the raw att feats; a stacked
    LSTM over [word; att_res]."""

    def extra_init(self, device) -> None:
        self.img_linear = linear_init(self.fc_feat_size,
                                      self.num_layers * self.rnn_size,
                                      device=device)

    @property
    def att_identity(self) -> bool:
        return True

    @property
    def embed_plain(self) -> bool:
        return True

    def make_decoder(self, feats: Features, *, training: bool = False,
                     generator: Optional[torch.Generator] = None,
                     aux_out: Optional[dict] = None):
        ctx, _ = super().make_decoder(feats, training=training,
                                      generator=generator)
        img = linear(self.img_linear, feats.fc_feats).reshape(
            feats.fc_feats.shape[0], self.num_layers, self.rnn_size)
        return ctx, (img, img)

    def core_init(self, device) -> nn.ModuleDict:
        return nn.ModuleDict({
            "lstm": rnn.init_stacked_lstm(
                self.num_layers, self.input_encoding_size + self.att_feat_size,
                self.rnn_size, device=device),
            "attention": attention_init(self.rnn_size, self.att_hid_size,
                                        device=device),
        })

    def core_step(self, xt, ctx, state, *, training, generator):
        p = self.core
        h, c = state
        att_res = attention_apply(p["attention"], h[:, -1], ctx["att"],
                                  ctx["p_att"], ctx["masks"],
                                  training=training)
        top, hs, cs = rnn.stacked_lstm_step(
            p["lstm"], torch.cat([xt, att_res], -1), h.transpose(0, 1),
            c.transpose(0, 1), generator=generator if training else None,
            dropout=self.drop_prob_lm)
        out = dropout(top, self.drop_prob_lm, training, generator)
        return out, (hs.transpose(0, 1), cs.transpose(0, 1))
