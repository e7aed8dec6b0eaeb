"""NMT seq2seq: BiLSTM encoder + stacked-LSTM decoder with global attention,
the zh->en translator of the pivot pipeline (counterpart of
`unpaired_image_captioning_tpu/models/nmt.py`).

- `Embeddings` / `embed_tokens`: word LUT with PAD embedding to exactly 0,
  optional sinusoid positional encoding (5,000 rows, per-row offsets) with
  dropout after it; on the source side optional `word￨feat` feature LUTs
  and the ReLU(linear) back to `word_vec_size` (`emb_mlp`);
- `NMTEncoder`: `layers`-layer bidirectional LSTM, rnn_size/2 per
  direction, length masks instead of packed sequences; the reverse
  direction runs over the flipped padded sequence and holds its state
  through the padding; optional per-word fertility head;
- `NMTImageEncoder`: im2text's row-embedded feature grid through the same
  BiLSTM;
- `global_attention_apply`: Luong dotprod or Bahdanau mlp scores, the
  softmax / sparsemax / constrained transforms of
  `ops/attention_transforms.py`, `c_attn` upper-bound bias;
- `NMTDecoder`: stacked LSTM with or without input feed, fertility upper
  bounds with the <SINK> column re-pinned to 100 every step, coverage
  (fed back only with `coverage_feed`), context gates, a separate copy
  attention;
- `NMTModel`: teacher forcing (`forward`, optionally rematerialised with
  `torch.utils.checkpoint`), `gold_scores`, the copy generators, and
  `translate_batch` through the OpenNMT beam (`onmt_beam_search`) with the
  per-step source-attention argmax recorded for UNK replacement.

Layout: batch-major everywhere ([B, T]). Every recurrent quantity the
decoder carries (`h`, `c`, `input_feed`, `attn`, `t`, `upper_bounds`,
`coverage`, `copy_attn`) is a [B(*K), ...] tensor of the state dict, so
the beam's backpointer reorder carries it.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
from torch import nn

from .. import constants as C

from ..ops import rnn
from ..ops.attention_transforms import TRANSFORMS
from ..ops.masking import length_mask
from .base import (dot_f32, dropout as _dropout, init_module, linear,
                   linear_init, resolve_device)
from .transformer import positional_encoding

PE_ROWS = 5000


@functools.lru_cache(maxsize=None)
def _pe_table(dim: int, device: str) -> torch.Tensor:
    return positional_encoding(PE_ROWS, dim, device=torch.device(device))


class Embeddings(nn.Module):
    """`word_lut` [vocab, dim] (PAD row embeds to 0); with `feature_sizes`
    one LUT of width `feature_vec_size` a feature column
    (`feature_luts.j`), and with `mlp` or features `linear`, which maps the
    concatenation back to `dim`."""

    def __init__(self, vocab: int, dim: int, *, feature_sizes=(),
                 feature_vec_size: int = 100, mlp: bool = False,
                 device=None):
        super().__init__()
        self.word_lut = nn.Parameter(torch.empty((vocab, dim), device=device))
        if feature_sizes:
            self.feature_luts = nn.ParameterList(
                nn.Parameter(torch.empty((n, feature_vec_size),
                                         device=device))
                for n in feature_sizes)
        if mlp or feature_sizes:
            self.linear = linear_init(
                dim + len(feature_sizes) * feature_vec_size, dim,
                device=device)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """normal * 0.01 with the PAD row zeroed, as embeddings_init, for the
        word and feature tables; the linear as linear_init."""
        luts = [self.word_lut] + list(getattr(self, "feature_luts", []))
        for lut in luts:
            emb = torch.randn(lut.shape, generator=generator,
                              device=generator.device) * 0.01
            emb[C.PAD] = 0.0
            lut.copy_(emb)
        if hasattr(self, "linear"):
            self.linear.init_params(generator)


def embeddings_init(vocab: int, dim: int, *, device=None,
                    **kw) -> Embeddings:
    return Embeddings(vocab, dim, device=device, **kw)


def embed_tokens(p: Embeddings, ids: torch.Tensor, *,
                 position_encoding: bool = False, pos_offset=None,
                 dropout: float = 0.0, training: bool = False,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """ids [...] -> [..., E]; PAD embeds to exactly 0 (padding_idx parity).
    With `position_encoding`, the sinusoid of each position (`pos_offset`
    [B] per row, else 0..T-1 along the last axis) is added, then dropout."""
    emb = p.word_lut[ids]
    emb = emb * (ids != C.PAD)[..., None].to(emb.dtype)
    if position_encoding:
        pe = _pe_table(emb.shape[-1], str(emb.device))
        if pos_offset is None:
            t = ids.shape[-1] if ids.dim() > 1 else 1
            emb = emb + pe[:t][None].to(emb.dtype)
        else:
            emb = emb + pe[pos_offset.long()].to(emb.dtype)
        emb = _dropout(emb, dropout, training, generator)
    return emb


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

def _scan_dir(cell, x, lengths, reverse: bool, hidden_size: int):
    """One unidirectional LSTM layer over time with length masking."""
    b, s, _ = x.shape
    h = torch.zeros((b, hidden_size), dtype=x.dtype, device=x.device)
    c = h
    valid = length_mask(lengths, s, dtype=torch.bool)          # [B, S]
    outs = [None] * s
    for t in (range(s - 1, -1, -1) if reverse else range(s)):
        h_new, c_new = rnn.lstm_step(cell, x[:, t], h, c)
        v = valid[:, t, None]
        h = torch.where(v, h_new, h)
        c = torch.where(v, c_new, c)
        outs[t] = h
    out = torch.stack(outs, 1)                                  # [B, S, H]
    # zero outputs at padded positions (packed-sequence parity)
    return out * valid[..., None].to(out.dtype), h, c


def _bilstm_layers(num_layers: int, in_size: int, hidden: int, brnn: bool,
                   device) -> nn.ModuleList:
    layers = nn.ModuleList()
    for layer in range(num_layers):
        d_in = in_size if layer == 0 else hidden * (2 if brnn else 1)
        lp = nn.ModuleDict({"fwd": rnn.init_lstm_params(d_in, hidden,
                                                        device=device)})
        if brnn:
            lp["bwd"] = rnn.init_lstm_params(d_in, hidden, device=device)
        layers.append(lp)
    return layers


class NMTEncoder(nn.Module):
    """`emb_mlp`: ReLU(linear) over the source word embeddings (the main
    repository's encoder; the fork leaves it off). `feature_sizes`: one LUT
    of width `feature_vec_size` a `word￨feat` column, concatenated to the
    word embedding and mapped back by the same ReLU(linear).
    `predict_fertility`: the per-position head 1 + exp(W3 relu(W2 relu(W1
    [context; embedding]))) (fork Models.py:214-222, 275-287)."""

    def __init__(self, vocab_size: int, word_vec_size: int = 512,
                 rnn_size: int = 512, layers: int = 1, brnn: bool = True,
                 dropout: float = 0.3, position_encoding: bool = False, *,
                 emb_mlp: bool = False, feature_sizes=(),
                 feature_vec_size: int = 100,
                 predict_fertility: bool = False, device=None):
        super().__init__()
        self.vocab_size, self.word_vec_size = vocab_size, word_vec_size
        self.rnn_size, self.brnn, self.dropout = rnn_size, brnn, dropout
        self.num_layers = layers
        self.position_encoding = position_encoding
        self.emb_mlp = emb_mlp
        self.feature_sizes = tuple(feature_sizes)
        self.predict_fertility = predict_fertility
        if rnn_size % self.num_directions:
            raise ValueError("rnn_size must be divisible by the directions")
        self.embeddings = embeddings_init(
            vocab_size, word_vec_size, feature_sizes=self.feature_sizes,
            feature_vec_size=feature_vec_size, mlp=emb_mlp, device=device)
        if predict_fertility:
            d2 = 2 * rnn_size
            self.fertility_linear = linear_init(rnn_size + word_vec_size, d2,
                                                device=device)
            self.fertility_linear_2 = linear_init(d2, d2, device=device)
            self.fertility_out = linear_init(d2, 1, bias=False,
                                             device=device)
        self.layers = _bilstm_layers(layers, word_vec_size, self.hidden_size,
                                     brnn, device)

    @property
    def num_directions(self) -> int:
        return 2 if self.brnn else 1

    @property
    def hidden_size(self) -> int:
        return self.rnn_size // self.num_directions

    def init_params(self, generator: torch.Generator) -> "NMTEncoder":
        init_module(self, generator)
        return self

    def fertility_values(self, context, emb_x) -> torch.Tensor:
        """Per-position predicted fertility [B, S]."""
        h = torch.cat([context, emb_x], dim=-1)
        h = torch.relu(linear(self.fertility_linear, h))
        h = torch.relu(linear(self.fertility_linear_2, h))
        return 1.0 + torch.exp(dot_f32(h, self.fertility_out.w)[..., 0])

    def apply(self, src_ids, lengths, *, training: bool = False,
              generator: Optional[torch.Generator] = None, src_feats=None,
              with_fertility: bool = False):
        """src_ids: [B, S]; lengths: [B]; src_feats [B, S, n_feat] ids,
        required with `feature_sizes`. Returns (context [B, S, rnn], (h, c)
        each [layers, B, rnn]) with the bidirectional halves concatenated,
        between layers and in the final hidden; with `with_fertility` also
        the predicted fertility [B, S]."""
        emb = self.embeddings
        x = embed_tokens(emb, src_ids,
                         position_encoding=self.position_encoding,
                         dropout=self.dropout, training=training,
                         generator=generator)
        if self.feature_sizes:
            if src_feats is None:
                raise ValueError("the encoder was built with source "
                                 "features: pass src_feats")
            feats = [lut[src_feats[..., j]]
                     * (src_feats[..., j] != C.PAD)[..., None].to(x.dtype)
                     for j, lut in enumerate(emb.feature_luts)]
            x = torch.cat([x] + feats, dim=-1)
        if self.emb_mlp or self.feature_sizes:
            x = torch.relu(linear(emb.linear, x))
        emb_x = x
        finals_h, finals_c = [], []
        for li, lp in enumerate(self.layers):
            out_f, h_f, c_f = _scan_dir(lp["fwd"], x, lengths, False,
                                        self.hidden_size)
            if self.brnn:
                out_b, h_b, c_b = _scan_dir(lp["bwd"], x, lengths, True,
                                            self.hidden_size)
                x = torch.cat([out_f, out_b], dim=-1)
                finals_h.append(torch.cat([h_f, h_b], dim=-1))
                finals_c.append(torch.cat([c_f, c_b], dim=-1))
            else:
                x = out_f
                finals_h.append(h_f)
                finals_c.append(c_f)
            if li + 1 < self.num_layers:
                x = _dropout(x, self.dropout, training, generator)
        enc = (x, (torch.stack(finals_h), torch.stack(finals_c)))
        if with_fertility:
            if not self.predict_fertility:
                raise ValueError("with_fertility needs predict_fertility")
            return enc + (self.fertility_values(x, emb_x),)
        return enc


class NMTImageEncoder(nn.Module):
    """im2text-style image encoder for the NMT decoder (reference
    `onmt/modules/ImageEncoder.py`): the conv feature grid [B, H, W, C]
    plus a learned per-row embedding (`row_embed` [64, C]), flattened row
    by row through a bidirectional LSTM, gives an NMT (context, hidden)
    pair."""

    def __init__(self, feat_size: int = 2048, rnn_size: int = 512,
                 layers: int = 1, dropout: float = 0.3, *, device=None):
        super().__init__()
        if rnn_size % 2:
            raise ValueError("rnn_size must be divisible by the directions")
        self.feat_size, self.rnn_size = feat_size, rnn_size
        self.dropout = dropout
        self.hidden_size = rnn_size // 2
        self.layers = _bilstm_layers(layers, feat_size, self.hidden_size,
                                     True, device)
        self.row_embed = nn.Parameter(torch.empty((64, feat_size),
                                                  device=device))

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "NMTImageEncoder":
        init_module(self, generator)
        self.row_embed.copy_(torch.randn(self.row_embed.shape,
                                         generator=generator,
                                         device=generator.device) * 0.01)
        return self

    def apply(self, feat_grid: torch.Tensor):
        """feat_grid [B, H, W, C] -> (context [B, H*W, rnn], (h, c))."""
        b, h, w, c = feat_grid.shape
        x = feat_grid + self.row_embed[:h][None, :, None, :]
        x = x.reshape(b, h * w, c)
        lengths = torch.full((b,), h * w, dtype=torch.int64,
                             device=x.device)
        finals_h, finals_c = [], []
        for lp in self.layers:
            out_f, h_f, c_f = _scan_dir(lp["fwd"], x, lengths, False,
                                        self.hidden_size)
            out_b, h_b, c_b = _scan_dir(lp["bwd"], x, lengths, True,
                                        self.hidden_size)
            x = torch.cat([out_f, out_b], dim=-1)
            finals_h.append(torch.cat([h_f, h_b], dim=-1))
            finals_c.append(torch.cat([c_f, c_b], dim=-1))
        return x, (torch.stack(finals_h), torch.stack(finals_c))


# ---------------------------------------------------------------------------
# Global attention
# ---------------------------------------------------------------------------

def global_attention_init(dim: int, attn_type: str = "dotprod", *,
                          device=None) -> nn.ModuleDict:
    if attn_type == "dotprod":
        return nn.ModuleDict({
            "linear_in": linear_init(dim, dim, bias=False, device=device),
            "linear_out": linear_init(2 * dim, dim, bias=False,
                                      device=device),
        })
    if attn_type != "mlp":
        raise ValueError(f"unknown attention type {attn_type!r}")
    return nn.ModuleDict({                                  # Bahdanau
        "linear_context": linear_init(dim, dim, bias=False, device=device),
        "linear_query": linear_init(dim, dim, bias=False, device=device),
        "v": linear_init(dim, 1, bias=False, device=device),
    })


def global_attention_apply(p: nn.ModuleDict, query, context, *,
                           attn_type: str = "dotprod",
                           attn_transform: str = "softmax", mask=None,
                           upper_bounds=None, c_attn: float = 0.0):
    """query [B*K, D], context [B, S, D] -> (attn_out [B*K, D], attn
    [B*K, S]).

    Dotprod: scores q W_in . ctx, output tanh(W_out [weighted; query]).
    mlp: scores v . tanh(W_ctx ctx + W_q q), output the weighted context.
    The constrained transforms add `c_attn` x the upper bounds (the <SINK>
    column as 0) to the scores and cap the weights at the bounds. With
    K > 1 (beam search) the context and mask stay [B, ...] and are shared
    by the K beams.
    """
    bq = query.shape[0]
    bm = context.shape[0]
    k = bq // bm
    if attn_type == "dotprod":
        q = linear(p["linear_in"], query)
        scores = torch.einsum("bsd,bkd->bks", context, q.reshape(bm, k, -1))
    else:
        # f32 products, as JAX's preferred_element_type leaves them
        wq = dot_f32(query, p["linear_query"].w).reshape(bm, k, -1)
        uh = dot_f32(context, p["linear_context"].w)
        wquh = torch.tanh(uh[:, None, :, :] + wq[:, :, None, :])
        scores = dot_f32(wquh, p["v"].w)[..., 0]
    scores = scores.reshape(bq, -1).float()
    if (c_attn != 0.0 and upper_bounds is not None
            and "constrained" in attn_transform):
        ub = torch.cat([upper_bounds[:, :-1],
                        torch.zeros_like(upper_bounds[:, -1:])], dim=-1)
        scores = scores + c_attn * ub
    if mask is not None and mask.shape[0] != bq:
        mask = mask.repeat_interleave(k, dim=0)
    attn = TRANSFORMS[attn_transform](scores, mask=mask,
                                      upper_bounds=upper_bounds)
    weighted = torch.einsum("bks,bsd->bkd",
                            attn.reshape(bm, k, -1).to(context.dtype),
                            context).reshape(bq, -1)
    if attn_type == "dotprod":
        out = torch.tanh(dot_f32(torch.cat([weighted, query], -1),
                                 p["linear_out"].w)).to(query.dtype)
    else:
        out = weighted
    return out, attn


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

SINK_BOUND = 100.0


class NMTDecoder(nn.Module):
    """`coverage_feed`: the reference builds `linear_cover` but never
    passes coverage into its attention, so coverage accumulates without
    effect unless this opts into tanh(ctx + linear_cover(coverage))."""

    def __init__(self, vocab_size: int, word_vec_size: int = 512,
                 rnn_size: int = 512, layers: int = 1, input_feed: int = 1,
                 dropout: float = 0.3, attention_type: str = "dotprod",
                 attn_transform: str = "softmax", c_attn: float = 0.0,
                 fertility: Optional[float] = None,
                 coverage_attn: bool = False,
                 context_gate: Optional[str] = None,
                 position_encoding: bool = False, copy_attn: bool = False,
                 *, coverage_feed: bool = False, device=None):
        super().__init__()
        if attn_transform not in TRANSFORMS:
            raise ValueError(f"unknown attention transform "
                             f"{attn_transform!r}")
        if context_gate not in (None, "source", "target", "both"):
            raise ValueError(f"unknown context gate {context_gate!r}")
        self.vocab_size, self.word_vec_size = vocab_size, word_vec_size
        self.rnn_size, self.dropout = rnn_size, dropout
        self.input_feed = input_feed
        self.attention_type, self.attn_transform = (attention_type,
                                                    attn_transform)
        self.c_attn, self.fertility = c_attn, fertility
        self.coverage_attn, self.coverage_feed = coverage_attn, coverage_feed
        self.context_gate = context_gate
        # the flag is `use_copy`: `copy_attn` names the copy attention's
        # parameters, as in the JAX tree
        self.position_encoding, self.use_copy = position_encoding, copy_attn
        self.embeddings = embeddings_init(vocab_size, word_vec_size,
                                          device=device)
        self.rnn = rnn.init_stacked_lstm(layers, self.rnn_input_size,
                                         rnn_size, device=device)
        self.attn = global_attention_init(rnn_size, attention_type,
                                          device=device)
        if context_gate is not None:
            # the gate reads the input-fed embedding (see step)
            emb_w = self.rnn_input_size
            self.gate = nn.ModuleDict({
                "gate": linear_init(emb_w + 2 * rnn_size, rnn_size,
                                    device=device),
                "source_proj": linear_init(rnn_size, rnn_size,
                                           device=device),
                "target_proj": linear_init(emb_w + rnn_size, rnn_size,
                                           device=device),
            })
        if coverage_attn:
            self.linear_cover = linear_init(1, rnn_size, bias=False,
                                            device=device)
        if copy_attn:
            self.copy_attn = global_attention_init(rnn_size, attention_type,
                                                   device=device)

    @property
    def rnn_input_size(self) -> int:
        return self.word_vec_size + (self.rnn_size if self.input_feed else 0)

    @property
    def constrained(self) -> bool:
        return "constrained" in self.attn_transform

    def init_params(self, generator: torch.Generator) -> "NMTDecoder":
        init_module(self, generator)
        return self

    def init_state(self, enc_hidden, context, upper_bounds_init=None) -> dict:
        """Hidden from the encoder, zero input feed, zero attention, step
        counter 0; with a constrained transform the upper bounds (from
        `upper_bounds_init` [B, S], else the constant `fertility`, 2.0 when
        None) with the <SINK> column at 100; zero coverage and copy
        attention when built with them."""
        h, c = enc_hidden                                   # [L, B, rnn]
        b, s = h.shape[1], context.shape[1]
        f32 = dict(dtype=torch.float32, device=context.device)
        state = {
            "h": h.transpose(0, 1).contiguous(),            # [B, L, H]
            "c": c.transpose(0, 1).contiguous(),
            "input_feed": torch.zeros((b, self.rnn_size), dtype=context.dtype,
                                      device=context.device),
            "attn": torch.zeros((b, s), **f32),
            "t": torch.zeros((b,), dtype=torch.int64, device=context.device),
        }
        if self.constrained:
            if upper_bounds_init is not None:
                ub = upper_bounds_init.float()
            else:
                fert = self.fertility if self.fertility is not None else 2.0
                ub = torch.full((b, s), float(fert), **f32)
            state["upper_bounds"] = _pin_sink(ub)
        if self.coverage_attn:
            state["coverage"] = torch.zeros((b, s), **f32)
        if self.use_copy:
            state["copy_attn"] = torch.zeros((b, s), **f32)
        return state

    def step(self, context, state, it, *, src_mask=None,
             training: bool = False,
             generator: Optional[torch.Generator] = None, pos=None):
        """One decode step. it: [B] token ids; `pos` [B] overrides the
        state's per-row step counter for the positional encoding.
        Returns (output [B, rnn], attn [B, S], new state)."""
        gen = generator if training else None
        emb = embed_tokens(self.embeddings, it,
                           position_encoding=self.position_encoding,
                           pos_offset=state["t"] if pos is None else pos,
                           dropout=self.dropout, training=training,
                           generator=gen)
        emb_in = (torch.cat([emb, state["input_feed"]], dim=-1)
                  if self.input_feed else emb)
        rnn_out, hs, cs = rnn.stacked_lstm_step(
            self.rnn, emb_in, state["h"].transpose(0, 1),
            state["c"].transpose(0, 1), generator=gen, dropout=self.dropout)
        ctx_in = context
        if self.coverage_attn and self.coverage_feed:
            ctx_in = torch.tanh(context + linear(
                self.linear_cover, state["coverage"][..., None]).to(
                    context.dtype))
        ub = state.get("upper_bounds")
        if ub is not None:
            # the reference re-pins the <SINK> bound to 100 every step
            # before the attention: the post-step decrement on the sink
            # column never survives
            ub = _pin_sink(ub)
        attn_out, attn = global_attention_apply(
            self.attn, rnn_out, ctx_in, attn_type=self.attention_type,
            attn_transform=self.attn_transform, mask=src_mask,
            upper_bounds=ub, c_attn=self.c_attn)
        if self.context_gate is not None:
            # the gate reads the input-fed embedding emb_in
            g = self.gate
            z = torch.sigmoid(linear(g["gate"], torch.cat(
                [emb_in, rnn_out, attn_out], -1)).float()).to(emb.dtype)
            src_p = linear(g["source_proj"], attn_out)
            tgt_p = linear(g["target_proj"], torch.cat([emb_in, rnn_out], -1))
            if self.context_gate == "source":
                out = torch.tanh(tgt_p + z * src_p)
            elif self.context_gate == "target":
                out = torch.tanh(z * tgt_p + src_p)
            else:
                out = torch.tanh((1.0 - z) * tgt_p + z * src_p)
        else:
            out = attn_out
        out = _dropout(out, self.dropout, training, gen)
        new_state = dict(state)
        new_state.update(h=hs.transpose(0, 1), c=cs.transpose(0, 1),
                         attn=attn, t=state["t"] + 1)
        if self.input_feed:
            new_state["input_feed"] = out
        if self.use_copy:
            # the copy stage: its own attention from the output over the
            # raw context
            _, new_state["copy_attn"] = global_attention_apply(
                self.copy_attn, out, context,
                attn_type=self.attention_type, mask=src_mask)
        if ub is not None:
            new_state["upper_bounds"] = ub - attn
        if self.coverage_attn:
            new_state["coverage"] = state["coverage"] + attn
        return out, attn, new_state


def _pin_sink(ub: torch.Tensor) -> torch.Tensor:
    """The upper bounds with the <SINK> (last) column set to 100."""
    return torch.cat([ub[:, :-1], torch.full_like(ub[:, -1:], SINK_BOUND)],
                     dim=-1)


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------

def constructor_args(scope: dict) -> dict:
    """A constructor's arguments from its `locals()` taken first thing, the
    device aside: what a checkpoint's `nmt_config.json` holds."""
    return {k: v for k, v in scope.items()
            if k not in ("self", "device", "__class__")}


class _Bias(nn.Module):
    """The generator's bias alone (`share_decoder_embeddings`)."""

    def __init__(self, dim: int, *, device=None):
        super().__init__()
        self.b = nn.Parameter(torch.empty((dim,), device=device))

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        self.b.zero_()


class NMTModel(nn.Module):
    """The JAX `NMTModel`'s fields, plus `remat` (each decoder step of
    `forward` under `torch.utils.checkpoint`) and the device."""

    def __init__(self, src_vocab_size: int, tgt_vocab_size: int,
                 word_vec_size: int = 512, rnn_size: int = 512,
                 layers: int = 1, brnn: bool = True, input_feed: int = 1,
                 dropout: float = 0.3, attention_type: str = "dotprod",
                 attn_transform: str = "softmax", c_attn: float = 0.0,
                 fertility: Optional[float] = None,
                 coverage_attn: bool = False,
                 context_gate: Optional[str] = None,
                 position_encoding: bool = False,
                 share_decoder_embeddings: bool = False,
                 copy_attn: bool = False, max_decode_len: int = 100,
                 beam_size: int = 15, truncated_decoder: int = 0,
                 coverage_feed: bool = False, src_emb_mlp: bool = False,
                 src_feature_sizes=(), feature_vec_size: int = 100,
                 predict_fertility: bool = False, remat: bool = False, *,
                 device=None):
        super().__init__()
        # the arguments `NMTModel(**init_args)` rebuilds it from
        self.init_args = constructor_args(locals())
        src_feature_sizes = tuple(src_feature_sizes or ())
        self.init_args["src_feature_sizes"] = src_feature_sizes
        if share_decoder_embeddings and word_vec_size != rnn_size:
            raise ValueError("share_decoder_embeddings needs word_vec_size "
                             "== rnn_size")
        self.src_vocab_size, self.tgt_vocab_size = src_vocab_size, tgt_vocab_size
        self.rnn_size = rnn_size
        self.max_decode_len, self.beam_size = max_decode_len, beam_size
        self.copy_attn = copy_attn
        self.coverage_attn, self.coverage_feed = coverage_attn, coverage_feed
        self.predict_fertility = predict_fertility
        self.share_decoder_embeddings = share_decoder_embeddings
        self.remat = remat
        # truncated-BPTT segment length: no gradient crosses a boundary
        self.truncated_decoder = truncated_decoder
        self.encoder = NMTEncoder(
            src_vocab_size, word_vec_size, rnn_size, layers, brnn, dropout,
            position_encoding, emb_mlp=src_emb_mlp,
            feature_sizes=src_feature_sizes,
            feature_vec_size=feature_vec_size,
            predict_fertility=predict_fertility, device=device)
        self.decoder = NMTDecoder(
            tgt_vocab_size, word_vec_size, rnn_size, layers, input_feed,
            dropout, attention_type, attn_transform, c_attn, fertility,
            coverage_attn, context_gate, position_encoding, copy_attn,
            coverage_feed=coverage_feed, device=device)
        self.generator = (_Bias(tgt_vocab_size, device=device)
                          if share_decoder_embeddings else
                          linear_init(rnn_size, tgt_vocab_size,
                                      device=device))
        if copy_attn:
            self.copy_gate = linear_init(rnn_size, 1, device=device)

    @classmethod
    def from_config(cls, cfg, *, device="cuda") -> "NMTModel":
        """Build from a config object (the fields the JAX `from_config`
        reads), on the card unless `device` names another."""
        return cls(
            src_vocab_size=cfg.nmt_src_vocab_size,
            tgt_vocab_size=cfg.nmt_tgt_vocab_size,
            word_vec_size=cfg.word_vec_size, rnn_size=cfg.rnn_size,
            layers=cfg.layers, brnn=cfg.brnn, input_feed=cfg.input_feed,
            dropout=cfg.dropout, attention_type=cfg.attention_type,
            attn_transform=cfg.attn_transform, c_attn=cfg.c_attn,
            fertility=cfg.fertility, coverage_attn=cfg.coverage_attn,
            coverage_feed=getattr(cfg, "coverage_feed", False),
            context_gate=cfg.context_gate,
            position_encoding=cfg.position_encoding,
            share_decoder_embeddings=cfg.share_decoder_embeddings,
            copy_attn=cfg.copy_attn,
            src_feature_sizes=tuple(
                getattr(cfg, "nmt_src_feature_sizes", ()) or ()),
            feature_vec_size=getattr(cfg, "feature_vec_size", 100),
            predict_fertility=getattr(cfg, "predict_fertility", False),
            truncated_decoder=getattr(cfg, "truncated_decoder", 0),
            device=resolve_device(device))

    @property
    def device(self) -> torch.device:
        return self.generator.b.device

    def init_params(self, generator: torch.Generator) -> "NMTModel":
        init_module(self, generator)
        return self

    def generator_logits(self, output: torch.Tensor) -> torch.Tensor:
        """f32 logits: the product in the output's type, then widened (the
        shared table's product in f32), as JAX's generator_logits."""
        if self.share_decoder_embeddings:
            return dot_f32(output, self.tgt_embedding().t()) + self.generator.b
        return linear(self.generator, output).float()

    @torch.no_grad()
    def load_pretrained_embeddings(self, *, enc_path: str = "",
                                   dec_path: str = "") -> "NMTModel":
        """Overwrite the word tables with pretrained ones (fork
        train.py:442-443 load_pretrained_vectors; Models.py:136-139; JAX
        `models/nmt.py:608-628`): `.npy`, or `.npz` with an `embedding`
        array, of the table's shape [vocab, word_vec]."""
        for path, side in ((enc_path, "encoder"), (dec_path, "decoder")):
            if not path:
                continue
            blob = np.load(path)
            table = np.asarray(blob["embedding"] if hasattr(blob, "files")
                               else blob, np.float32)
            lut = getattr(self, side).embeddings.word_lut
            if table.shape != tuple(lut.shape):
                raise ValueError(f"{side} pretrained embeddings "
                                 f"{table.shape} vs {tuple(lut.shape)}")
            lut.copy_(torch.from_numpy(table))
        return self

    def src_embedding(self) -> torch.Tensor:
        """The source word table (the Weight_Trans coupling point)."""
        return self.encoder.embeddings.word_lut

    def tgt_embedding(self) -> torch.Tensor:
        """The target word table (the Weight_Trans_y coupling point)."""
        return self.decoder.embeddings.word_lut

    # ---- copy generators ---------------------------------------------------
    def _copy_parts(self, outputs, *, mask_unk_pad: bool = False):
        """(p_vocab, p_copy) of the copy generators: the generator's softmax
        (UNK and PAD at -inf with `mask_unk_pad`) and the copy gate's
        sigmoid [..., 1]."""
        logits = self.generator_logits(outputs).float()
        if mask_unk_pad:
            logits = logits.clone()
            logits[..., C.UNK] = -float("inf")
            logits[..., C.PAD] = -float("inf")
        p_copy = torch.sigmoid(linear(self.copy_gate, outputs).float())
        return torch.softmax(logits, dim=-1), p_copy

    def _map_src(self, src2tgt, src_ids) -> torch.Tensor:
        s2t = torch.as_tensor(np.asarray(src2tgt) if not torch.is_tensor(
            src2tgt) else src2tgt, device=src_ids.device).long()
        return s2t[src_ids.long()]

    def copy_generator_logprobs(self, outputs, copy_attns, src_ids,
                                src2tgt) -> torch.Tensor:
        """The normalised collapsed copy mixture of the JAX package:

            p(w) = (1 - p_copy) softmax(Wh)[w]
                 + p_copy sum_j attn_j [src2tgt[src_j] == w]

        outputs [B(, T), rnn]; copy_attns [B(, T), S]; src_ids [B, S];
        src2tgt [src_vocab] (Dict.align). Returns log max(p, 1e-20)."""
        p_vocab, p_copy = self._copy_parts(outputs)
        tgt_of_src = self._map_src(src2tgt, src_ids)
        copy_dist = _scatter_copy(copy_attns.float(), tgt_of_src, None,
                                  self.tgt_vocab_size)
        p = (1.0 - p_copy) * p_vocab + p_copy * copy_dist
        return torch.log(torch.clamp_min(p, 1e-20))

    def copy_generator_fold_logprobs(self, outputs, copy_attns, src_ids,
                                     src2tgt) -> torch.Tensor:
        """The reference's decode-time CopyGenerator scoring
        (onmt/modules/CopyGenerator.py:36-48 with the beam fold of
        onmt/Translator.py:207-226): the generator's softmax with UNK and
        PAD at -inf times (1 - p_copy), plus p_copy x attn_j on
        align[src_j] for the source words that align (not PAD); the copy
        mass of unaligned words is dropped, so the result is the log of a
        sub-normalised distribution."""
        p_vocab, p_copy = self._copy_parts(outputs, mask_unk_pad=True)
        tgt_of_src = self._map_src(src2tgt, src_ids)
        fold = _scatter_copy(copy_attns.float(), tgt_of_src,
                             (tgt_of_src != C.PAD).float(),
                             self.tgt_vocab_size)
        p = (1.0 - p_copy) * p_vocab + p_copy * fold
        return torch.log(torch.clamp_min(p, 1e-20))

    def copy_train_loss(self, outputs, copy_attns, tgt_ids, align_mask, *,
                        eps: float = 1e-12):
        """The reference's copy training criterion (CopyGenerator.forward +
        CopyCriterion, onmt/Loss.py:143-147):

            out_prob = (1 - g) softmax(logits with UNK / PAD at -inf)
            copies   = sum_j g attn_j align_j + eps
            loss     = -sum_nonpad log(out_prob[targ] + copies + eps)

        n_correct counts the argmax of out_prob. align_mask [B, T, S]: 1
        where the gold token at step t copies source position j. Returns
        (summed loss, NMTStats)."""
        from ..losses.criterion import NMTStats

        p_vocab, g = self._copy_parts(outputs, mask_unk_pad=True)
        out_prob = (1.0 - g) * p_vocab
        tg = tgt_ids.long()
        p_targ = torch.gather(out_prob, -1, tg[..., None])[..., 0]
        copies = (g * copy_attns.float() * align_mask.float()).sum(-1) + eps
        non_pad = (tg != C.PAD).float()
        loss = -(torch.log(p_targ + copies + eps) * non_pad).sum()
        pred = out_prob.argmax(dim=-1)
        return loss, NMTStats(loss, non_pad.sum(),
                              ((pred == tg).float() * non_pad).sum())

    @staticmethod
    def src_first_occurrence(src_ids: torch.Tensor) -> torch.Tensor:
        """c[b, j] = the first position i with src[b, i] == src[b, j]: the
        per-row slot of the source word in the extended vocab."""
        s = src_ids.shape[1]
        eq = src_ids[:, :, None] == src_ids[:, None, :]          # [B, j, i]
        pos = torch.arange(s, device=src_ids.device)[None, None, :]
        return torch.where(eq, pos, torch.full_like(pos, s)).amin(dim=-1)

    def copy_generator_extended_logprobs(self, outputs, copy_attns, src_ids,
                                         src2tgt) -> torch.Tensor:
        """The extended-dynamic-vocab CopyGenerator: log p over
        [tgt_vocab + S]. Copy mass of source words inside the target vocab
        folds onto the target word (PAD source positions onto PAD); the
        mass of unmapped words (UNK or PAD in `src2tgt`) lands on extended
        slot V + first_occurrence(j), an exact copy of the source word.

        outputs [B(, T), rnn]; copy_attns [B(, T), S]; src_ids [B, S]."""
        V = self.tgt_vocab_size
        p_vocab, p_copy = self._copy_parts(outputs)
        tgt_of_src = self._map_src(src2tgt, src_ids)
        live = src_ids != C.PAD
        in_vocab = (((tgt_of_src != C.UNK) & (tgt_of_src != C.PAD))
                    | ~live)
        tgt_fold = torch.where(live, tgt_of_src,
                               torch.full_like(tgt_of_src, C.PAD))
        attn = copy_attns.float()
        to_vocab = _scatter_copy(attn, tgt_fold, in_vocab.float(), V)
        to_ext = _scatter_copy(attn, self.src_first_occurrence(src_ids),
                               (~in_vocab).float(), src_ids.shape[1])
        p = torch.cat([(1.0 - p_copy) * p_vocab + p_copy * to_vocab,
                       p_copy * to_ext], dim=-1)
        return torch.log(torch.clamp_min(p, 1e-20))

    def extended_copy_targets(self, tgt_ids, alignment, src_ids):
        """Targets in the extended vocab for the forced-copy criterion:
        where the gold token is UNK and `alignment` [B, T] names a source
        position (-1: none), V + first_occurrence(position)."""
        first = self.src_first_occurrence(src_ids)
        pos = alignment.long().clamp(0, src_ids.shape[1] - 1)
        ext = self.tgt_vocab_size + torch.gather(first, 1, pos)
        use = (tgt_ids == C.UNK) & (alignment >= 0)
        return torch.where(use, ext, tgt_ids.long())

    def resolve_extended(self, seq):
        """Split decoded extended-vocab ids: (tgt_seq, copy_pos), extended
        ids as UNK in tgt_seq and their source position in copy_pos (-1 for
        a vocabulary token)."""
        V = self.tgt_vocab_size
        is_ext = seq >= V
        return (torch.where(is_ext, torch.full_like(seq, C.UNK), seq),
                torch.where(is_ext, seq - V, torch.full_like(seq, -1)))

    # ---- training forward --------------------------------------------------
    def _encode(self, src_ids, src_lengths, *, training=False,
                generator=None, src_feats=None, src_fertilities=None):
        """(context, encoder hidden, initial decoder state): the upper
        bounds start from `src_fertilities` [B, S] when given, else from
        the predicted fertility head."""
        enc = self.encoder.apply(
            src_ids, src_lengths, training=training, generator=generator,
            src_feats=src_feats,
            with_fertility=self.predict_fertility and src_fertilities is None)
        ub0 = src_fertilities if src_fertilities is not None else (
            enc[2] if len(enc) == 3 else None)
        return enc[0], self.decoder.init_state(enc[1], enc[0],
                                               upper_bounds_init=ub0)

    def forward(self, src_ids, src_lengths, tgt_ids, *,
                training: bool = False,
                generator: Optional[torch.Generator] = None,
                src_feats=None, src_fertilities=None):
        """Teacher forcing: src_ids [B, S], tgt_ids [B, T] with BOS ...
        EOS; the decoder reads tgt_ids[:, :-1]. Returns (decoder outputs
        [B, T-1, rnn], attentions [B, T-1, S]), or with copy attention
        (outputs, (attentions, copy attentions)). In training, dropout
        draws from `generator`. As in the JAX package, the decoder's
        attention takes no source mask here: the encoder's padded positions
        are zero. With `truncated_decoder` n, the decoder state is detached
        before every step idx > 0 with idx % n == 0. With `remat`, each
        step is recomputed in the backward; its dropout masks are drawn
        again from the generator state the forward saw."""
        context, state = self._encode(
            src_ids, src_lengths, training=training, generator=generator,
            src_feats=src_feats, src_fertilities=src_fertilities)
        dec = self.decoder
        trunc = self.truncated_decoder
        gen = generator if training else None
        outs, attns, extras = [], [], []
        for idx in range(tgt_ids.shape[1] - 1):
            if trunc and idx > 0 and idx % trunc == 0:
                state = {k: v.detach() for k, v in state.items()}
            tok = tgt_ids[:, idx]
            if self.remat and torch.is_grad_enabled():
                out, attn, state = _remat_step(dec, context, state, tok,
                                               training, gen)
            else:
                out, attn, state = dec.step(context, state, tok,
                                            training=training, generator=gen)
            outs.append(out)
            attns.append(attn)
            if self.copy_attn:
                extras.append(state["copy_attn"])
        outs, attns = torch.stack(outs, 1), torch.stack(attns, 1)
        if self.copy_attn:
            return outs, (attns, torch.stack(extras, 1))
        return outs, attns

    def gold_scores(self, src_ids, src_lengths, tgt_ids, *,
                    src_feats=None) -> torch.Tensor:
        """Per-sentence log-likelihood of the gold targets tgt_ids [B, T]
        (BOS ... EOS, PAD-padded): the gathered log-probabilities of
        tgt_ids[:, 1:] under the plain generator (also with copy
        attention, as in JAX), PAD positions zeroed, summed. Returns [B]
        f32."""
        fk = {} if src_feats is None else {"src_feats": src_feats}
        return _gold_scores(self, src_ids, src_lengths, tgt_ids, **fk)

    def translate_batch(self, src_ids, src_lengths, *,
                        beam_size: Optional[int] = None,
                        max_len: Optional[int] = None, src2tgt=None,
                        src_feats=None, src_fertilities=None,
                        copy_mode: str = "extended"):
        """Beam-translate a batch. Returns BeamResult with seq [B, beam, T]
        (BOS excluded, EOS included) and aux = the per-step source-attention
        argmax for UNK replacement.

        With copy attention and a `src2tgt` align map, `copy_mode`
        "extended" runs the beam over the extended vocab [V + S] (ids >= V
        are exact copies of source positions; split them with
        `resolve_extended`), "fold" the reference's own decode-time scoring
        (`copy_generator_fold_logprobs`)."""
        from ..ops.beam_search import onmt_beam_search

        if copy_mode not in ("extended", "fold"):
            raise ValueError(f"copy_mode {copy_mode!r}")
        beam_size = beam_size or self.beam_size
        max_len = max_len or self.max_decode_len
        context, state0 = self._encode(src_ids, src_lengths,
                                       src_feats=src_feats,
                                       src_fertilities=src_fertilities)
        dec = self.decoder
        src_mask = length_mask(src_lengths, src_ids.shape[1])
        ctx = {"context": context, "src_mask": src_mask}
        with_copy = self.copy_attn and src2tgt is not None
        if with_copy:
            ctx["src_ids"] = src_ids            # expanded with the beams
            s2t = torch.as_tensor(np.asarray(src2tgt) if not torch.is_tensor(
                src2tgt) else src2tgt, device=src_ids.device).long()
            copy_fn = (self.copy_generator_extended_logprobs
                       if copy_mode == "extended"
                       else self.copy_generator_fold_logprobs)

        def step_fn(c, state, it):
            if with_copy:
                # an extended id (an exact copy, >= V) is read back as the
                # last vocabulary word, as JAX's clamped gather reads it
                it = it.clamp(max=self.tgt_vocab_size - 1)
            out, _, state = dec.step(c["context"], state, it,
                                     src_mask=c["src_mask"])
            if with_copy:
                return copy_fn(out, state["copy_attn"], c["src_ids"],
                               s2t), state
            return torch.log_softmax(self.generator_logits(out), dim=-1), state

        # the encoder context stays unexpanded (read once per sentence)
        # unless coverage is fed back into it, which edits it per beam
        no_expand = (() if self.coverage_attn and self.coverage_feed
                     else ("context", "src_mask"))
        return onmt_beam_search(
            step_fn, ctx, state0, beam_size=beam_size, seq_length=max_len,
            bos_token=C.BOS, eos_token=C.EOS, ctx_no_expand=no_expand,
            record_aux_from_state=lambda st: st["attn"].argmax(dim=-1))


def _scatter_copy(attn: torch.Tensor, idx: torch.Tensor, weight,
                  width: int) -> torch.Tensor:
    """out[..., v] = sum_j attn[..., j] weight[b, j] [idx[b, j] == v], v in
    [0, width): the copy mass of the source positions j summed onto their
    ids by a scatter-add over the last axis (no [.., S, width] one-hot).
    attn [B, S] or [B, T, S]; idx, weight [B, S]."""
    vals = attn if weight is None else attn * (weight if attn.dim() == 2
                                               else weight[:, None, :])
    if attn.dim() == 3:
        idx = idx[:, None, :].expand_as(attn)
    out = torch.zeros(attn.shape[:-1] + (width,), dtype=attn.dtype,
                      device=attn.device)
    return out.scatter_add(-1, idx.long(), vals)


def _remat_step(dec: NMTDecoder, context, state, tok, training: bool,
                generator: Optional[torch.Generator]):
    """One decoder step under `torch.utils.checkpoint`: its activations
    are recomputed in the backward. The recompute restores `generator` to
    the state the forward started from (checkpoint restores only the
    global RNGs), so it draws the same dropout masks, and hands the
    generator back as it found it."""
    from torch.utils.checkpoint import checkpoint

    start = generator.get_state() if generator is not None else None
    calls = [0]

    def run(state, tok):
        calls[0] += 1
        if start is None or calls[0] == 1:
            return dec.step(context, state, tok, training=training,
                            generator=generator)
        now = generator.get_state()
        generator.set_state(start)
        try:
            return dec.step(context, state, tok, training=training,
                            generator=generator)
        finally:
            generator.set_state(now)

    return checkpoint(run, state, tok, use_reentrant=False,
                      preserve_rng_state=False)


def _gold_scores(model, src_ids, src_lengths, tgt_ids, **fk) -> torch.Tensor:
    """Gold scoring shared by both NMT families: teacher-forced outputs,
    log-softmax of the generator, the gold tokens' log-probabilities with
    PAD positions zeroed, summed over time."""
    outs = model.forward(src_ids, src_lengths, tgt_ids, **fk)[0]
    lp = torch.log_softmax(model.generator_logits(outs), dim=-1)
    gold = tgt_ids[:, 1:].long()
    tok = torch.gather(lp, -1, gold[..., None])[..., 0]
    return torch.sum(torch.where(gold != C.PAD, tok, torch.zeros_like(tok)),
                     dim=-1)
