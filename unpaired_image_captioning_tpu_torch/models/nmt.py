"""NMT seq2seq: BiLSTM encoder + input-feed stacked-LSTM decoder with Luong
dotprod global attention, the zh->en translator of the pivot pipeline
(counterpart of `unpaired_image_captioning_tpu/models/nmt.py`).

- `Embeddings`: word LUT with PAD embedding to exactly 0;
- `NMTEncoder`: `layers`-layer bidirectional LSTM, rnn_size/2 per direction,
  length masks instead of packed sequences; the reverse direction runs over
  the flipped padded sequence and holds its state through the padding;
- `NMTDecoder`: stacked LSTM with input feed, dotprod attention with a
  softmax transform over unexpanded [B, S] context;
- `NMTModel.forward`: teacher forcing for training (input feed, dropout
  from the caller's generator, `truncated_decoder` segments) and
  `gold_scores`;
- `NMTModel.translate_batch`: the OpenNMT beam (`onmt_beam_search`) with the
  per-step source-attention argmax recorded for UNK replacement.

Layout: batch-major everywhere ([B, T]). Copy attention, coverage, context
gates, fertility / constrained transforms, mlp attention, positional
encoding, source features and shared decoder embeddings are ROADMAP A11;
the constructors raise for them (and take no `remat`, also A11).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .. import constants as C

from ..ops import rnn
from ..ops.attention_transforms import TRANSFORMS
from ..ops.masking import length_mask
from .base import (dropout as _dropout, init_module, linear, linear_init,
                   resolve_device)


def _not_ported(what: str):
    raise NotImplementedError(f"NMT {what} is not ported yet (ROADMAP A11)")


class Embeddings(nn.Module):
    """`word_lut` [vocab, dim]; the PAD row embeds to 0."""

    def __init__(self, vocab: int, dim: int, *, device=None):
        super().__init__()
        self.word_lut = nn.Parameter(torch.empty((vocab, dim), device=device))

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """normal * 0.01 with the PAD row zeroed, as embeddings_init."""
        emb = torch.randn(self.word_lut.shape, generator=generator,
                          device=generator.device) * 0.01
        emb[C.PAD] = 0.0
        self.word_lut.copy_(emb)


def embeddings_init(vocab: int, dim: int, *, device=None) -> Embeddings:
    return Embeddings(vocab, dim, device=device)


def embed_tokens(p: Embeddings, ids: torch.Tensor) -> torch.Tensor:
    """ids [...] -> [..., E]; PAD embeds to exactly 0 (padding_idx parity).
    No positional encoding (ROADMAP A11)."""
    emb = p.word_lut[ids]
    return emb * (ids != C.PAD)[..., None].to(emb.dtype)


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

class NMTEncoder(nn.Module):
    def __init__(self, vocab_size: int, word_vec_size: int = 512,
                 rnn_size: int = 512, layers: int = 1, brnn: bool = True,
                 dropout: float = 0.3, *, device=None):
        super().__init__()
        self.vocab_size, self.word_vec_size = vocab_size, word_vec_size
        self.rnn_size, self.brnn, self.dropout = rnn_size, brnn, dropout
        self.num_layers = layers
        if rnn_size % self.num_directions:
            raise ValueError("rnn_size must be divisible by the directions")
        self.embeddings = embeddings_init(vocab_size, word_vec_size,
                                          device=device)
        self.layers = nn.ModuleList()
        for layer in range(layers):
            in_size = (word_vec_size if layer == 0
                       else self.hidden_size * self.num_directions)
            lp = nn.ModuleDict({"fwd": rnn.init_lstm_params(
                in_size, self.hidden_size, device=device)})
            if brnn:
                lp["bwd"] = rnn.init_lstm_params(in_size, self.hidden_size,
                                                 device=device)
            self.layers.append(lp)

    @property
    def num_directions(self) -> int:
        return 2 if self.brnn else 1

    @property
    def hidden_size(self) -> int:
        return self.rnn_size // self.num_directions

    def init_params(self, generator: torch.Generator) -> "NMTEncoder":
        init_module(self, generator)
        return self

    def _scan_dir(self, cell, x, lengths, reverse: bool):
        """One unidirectional LSTM layer over time with length masking."""
        b, s, _ = x.shape
        h = torch.zeros((b, self.hidden_size), dtype=x.dtype, device=x.device)
        c = h
        valid = length_mask(lengths, s, dtype=torch.bool)      # [B, S]
        outs = [None] * s
        for t in (range(s - 1, -1, -1) if reverse else range(s)):
            h_new, c_new = rnn.lstm_step(cell, x[:, t], h, c)
            v = valid[:, t, None]
            h = torch.where(v, h_new, h)
            c = torch.where(v, c_new, c)
            outs[t] = h
        out = torch.stack(outs, 1)                              # [B, S, H]
        # zero outputs at padded positions (packed-sequence parity)
        return out * valid[..., None].to(out.dtype), h, c

    def apply(self, src_ids, lengths, *, training: bool = False,
              generator: Optional[torch.Generator] = None):
        """src_ids: [B, S]; lengths: [B]. Returns (context [B, S, rnn],
        (h, c) each [layers, B, rnn]) with the bidirectional halves
        concatenated, between layers and in the final hidden."""
        x = embed_tokens(self.embeddings, src_ids)
        finals_h, finals_c = [], []
        for li, lp in enumerate(self.layers):
            out_f, h_f, c_f = self._scan_dir(lp["fwd"], x, lengths, False)
            if self.brnn:
                out_b, h_b, c_b = self._scan_dir(lp["bwd"], x, lengths, True)
                x = torch.cat([out_f, out_b], dim=-1)
                finals_h.append(torch.cat([h_f, h_b], dim=-1))
                finals_c.append(torch.cat([c_f, c_b], dim=-1))
            else:
                x = out_f
                finals_h.append(h_f)
                finals_c.append(c_f)
            if li + 1 < self.num_layers:
                x = _dropout(x, self.dropout, training, generator)
        return x, (torch.stack(finals_h), torch.stack(finals_c))


# ---------------------------------------------------------------------------
# Global attention
# ---------------------------------------------------------------------------

def global_attention_init(dim: int, attn_type: str = "dotprod", *,
                          device=None) -> nn.ModuleDict:
    if attn_type != "dotprod":
        _not_ported(f"{attn_type} attention")
    return nn.ModuleDict({
        "linear_in": linear_init(dim, dim, bias=False, device=device),
        "linear_out": linear_init(2 * dim, dim, bias=False, device=device),
    })


def global_attention_apply(p: nn.ModuleDict, query, context, *, mask=None,
                           attn_transform: str = "softmax"):
    """query [B*K, D], context [B, S, D] -> (attn_out [B*K, D], attn [B*K, S]).

    Dotprod scores, the pad mask applied by the transform, then
    tanh(linear_out([weighted context; query])). With K > 1 (beam search)
    the context and mask stay [B, ...] and are shared by the K beams.
    """
    bq = query.shape[0]
    bm = context.shape[0]
    k = bq // bm
    q = linear(p["linear_in"], query)
    scores = torch.einsum("bsd,bkd->bks", context, q.reshape(bm, k, -1))
    scores = scores.reshape(bq, -1)
    if mask is not None and mask.shape[0] != bq:
        mask = mask.repeat_interleave(k, dim=0)
    attn = TRANSFORMS[attn_transform](scores, mask=mask)
    weighted = torch.einsum("bks,bsd->bkd", attn.reshape(bm, k, -1),
                            context).reshape(bq, -1)
    out = torch.tanh(linear(p["linear_out"], torch.cat([weighted, query], -1)))
    return out, attn


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

class NMTDecoder(nn.Module):
    def __init__(self, vocab_size: int, word_vec_size: int = 512,
                 rnn_size: int = 512, layers: int = 1, input_feed: int = 1,
                 dropout: float = 0.3, attention_type: str = "dotprod",
                 attn_transform: str = "softmax", *, device=None):
        super().__init__()
        if not input_feed:
            _not_ported("decoder without input feed")
        if attn_transform not in TRANSFORMS:
            _not_ported(f"attention transform {attn_transform!r}")
        self.vocab_size, self.word_vec_size = vocab_size, word_vec_size
        self.rnn_size, self.dropout = rnn_size, dropout
        self.attn_transform = attn_transform
        self.embeddings = embeddings_init(vocab_size, word_vec_size,
                                          device=device)
        self.rnn = rnn.init_stacked_lstm(layers, self.rnn_input_size,
                                         rnn_size, device=device)
        self.attn = global_attention_init(rnn_size, attention_type,
                                          device=device)

    @property
    def rnn_input_size(self) -> int:
        return self.word_vec_size + self.rnn_size

    def init_params(self, generator: torch.Generator) -> "NMTDecoder":
        init_module(self, generator)
        return self

    def init_state(self, enc_hidden, context) -> dict:
        """Hidden from the encoder, zero input feed, zero attention."""
        h, c = enc_hidden                                   # [L, B, rnn]
        b, s = h.shape[1], context.shape[1]
        return {
            "h": h.transpose(0, 1).contiguous(),            # [B, L, H]
            "c": c.transpose(0, 1).contiguous(),
            "input_feed": torch.zeros((b, self.rnn_size), dtype=context.dtype,
                                      device=context.device),
            "attn": torch.zeros((b, s), dtype=torch.float32,
                                device=context.device),
        }

    def step(self, context, state, it, *, src_mask=None,
             training: bool = False,
             generator: Optional[torch.Generator] = None):
        """One input-feed decode step. it: [B] token ids.
        Returns (output [B, rnn], attn [B, S], new state)."""
        emb = embed_tokens(self.embeddings, it)
        emb_in = torch.cat([emb, state["input_feed"]], dim=-1)
        rnn_out, hs, cs = rnn.stacked_lstm_step(
            self.rnn, emb_in, state["h"].transpose(0, 1),
            state["c"].transpose(0, 1),
            generator=generator if training else None, dropout=self.dropout)
        attn_out, attn = global_attention_apply(
            self.attn, rnn_out, context, mask=src_mask,
            attn_transform=self.attn_transform)
        out = _dropout(attn_out, self.dropout, training, generator)
        new_state = {"h": hs.transpose(0, 1), "c": cs.transpose(0, 1),
                     "input_feed": out, "attn": attn}
        return out, attn, new_state


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------

class NMTModel(nn.Module):
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
                 beam_size: int = 15, truncated_decoder: int = 0, *,
                 device=None):
        super().__init__()
        for flag, what in ((copy_attn, "copy attention"),
                           (coverage_attn, "coverage attention"),
                           (context_gate, "context gate"),
                           (fertility is not None or c_attn != 0.0,
                            "fertility"),
                           (position_encoding, "positional encoding"),
                           (share_decoder_embeddings,
                            "shared decoder embeddings")):
            if flag:
                _not_ported(what)
        self.src_vocab_size, self.tgt_vocab_size = src_vocab_size, tgt_vocab_size
        self.rnn_size = rnn_size
        self.max_decode_len, self.beam_size = max_decode_len, beam_size
        # truncated-BPTT segment length: no gradient crosses a boundary
        self.truncated_decoder = truncated_decoder
        self.encoder = NMTEncoder(src_vocab_size, word_vec_size, rnn_size,
                                  layers, brnn, dropout, device=device)
        self.decoder = NMTDecoder(tgt_vocab_size, word_vec_size, rnn_size,
                                  layers, input_feed, dropout,
                                  attention_type, attn_transform,
                                  device=device)
        self.generator = linear_init(rnn_size, tgt_vocab_size, device=device)

    @classmethod
    def from_config(cls, cfg, *, device="cuda") -> "NMTModel":
        """Build from a config object, on the card unless `device` names
        another."""
        extras = {"nmt_src_feature_sizes": "source word features",
                  "predict_fertility": "predicted fertility",
                  "coverage_feed": "coverage feedback"}
        for name, what in extras.items():
            if getattr(cfg, name, None):
                _not_ported(what)
        return cls(
            src_vocab_size=cfg.nmt_src_vocab_size,
            tgt_vocab_size=cfg.nmt_tgt_vocab_size,
            word_vec_size=cfg.word_vec_size, rnn_size=cfg.rnn_size,
            layers=cfg.layers, brnn=cfg.brnn, input_feed=cfg.input_feed,
            dropout=cfg.dropout, attention_type=cfg.attention_type,
            attn_transform=cfg.attn_transform, c_attn=cfg.c_attn,
            fertility=cfg.fertility, coverage_attn=cfg.coverage_attn,
            context_gate=cfg.context_gate,
            position_encoding=cfg.position_encoding,
            share_decoder_embeddings=cfg.share_decoder_embeddings,
            copy_attn=cfg.copy_attn,
            truncated_decoder=getattr(cfg, "truncated_decoder", 0),
            device=resolve_device(device))

    @property
    def device(self) -> torch.device:
        return self.generator.w.device

    def init_params(self, generator: torch.Generator) -> "NMTModel":
        init_module(self, generator)
        return self

    def generator_logits(self, output: torch.Tensor) -> torch.Tensor:
        return linear(self.generator, output)

    def src_embedding(self) -> torch.Tensor:
        """The source word table (the Weight_Trans coupling point)."""
        return self.encoder.embeddings.word_lut

    def tgt_embedding(self) -> torch.Tensor:
        """The target word table (the Weight_Trans_y coupling point)."""
        return self.decoder.embeddings.word_lut

    def forward(self, src_ids, src_lengths, tgt_ids, *,
                training: bool = False,
                generator: Optional[torch.Generator] = None):
        """Teacher forcing: src_ids [B, S], tgt_ids [B, T] with BOS ...
        EOS; the decoder reads tgt_ids[:, :-1]. Returns (decoder outputs
        [B, T-1, rnn], attentions [B, T-1, S]). In training, dropout
        (between stacked layers and on the attention output) draws from
        `generator`. As in the JAX package, the decoder's attention takes
        no source mask here: the encoder's padded positions are zero. With
        `truncated_decoder` n, the decoder state is detached before every
        step idx > 0 with idx % n == 0."""
        context, enc_hidden = self.encoder.apply(
            src_ids, src_lengths, training=training, generator=generator)
        dec = self.decoder
        state = dec.init_state(enc_hidden, context)
        trunc = self.truncated_decoder
        outs, attns = [], []
        for idx in range(tgt_ids.shape[1] - 1):
            if trunc and idx > 0 and idx % trunc == 0:
                state = {k: v.detach() for k, v in state.items()}
            out, attn, state = dec.step(context, state, tgt_ids[:, idx],
                                        training=training,
                                        generator=generator)
            outs.append(out)
            attns.append(attn)
        return torch.stack(outs, 1), torch.stack(attns, 1)

    def gold_scores(self, src_ids, src_lengths, tgt_ids) -> torch.Tensor:
        """Per-sentence log-likelihood of the gold targets tgt_ids [B, T]
        (BOS ... EOS, PAD-padded): the gathered log-probabilities of
        tgt_ids[:, 1:], PAD positions zeroed, summed. Returns [B] f32."""
        return _gold_scores(self, src_ids, src_lengths, tgt_ids)

    def translate_batch(self, src_ids, src_lengths, *,
                        beam_size: Optional[int] = None,
                        max_len: Optional[int] = None):
        """Beam-translate a batch. Returns BeamResult with seq [B, beam, T]
        (BOS excluded, EOS included) and aux = the per-step source-attention
        argmax for UNK replacement."""
        from ..ops.beam_search import onmt_beam_search

        beam_size = beam_size or self.beam_size
        max_len = max_len or self.max_decode_len
        context, enc_hidden = self.encoder.apply(src_ids, src_lengths)
        dec = self.decoder
        state0 = dec.init_state(enc_hidden, context)
        src_mask = length_mask(src_lengths, src_ids.shape[1])
        ctx = {"context": context, "src_mask": src_mask}

        def step_fn(c, state, it):
            out, _, state = dec.step(c["context"], state, it,
                                     src_mask=c["src_mask"])
            logits = self.generator_logits(out)
            return torch.log_softmax(logits, dim=-1), state

        # the encoder context stays unexpanded: read once per sentence
        return onmt_beam_search(
            step_fn, ctx, state0, beam_size=beam_size, seq_length=max_len,
            bos_token=C.BOS, eos_token=C.EOS,
            ctx_no_expand=("context", "src_mask"),
            record_aux_from_state=lambda st: st["attn"].argmax(dim=-1))



def _gold_scores(model, src_ids, src_lengths, tgt_ids) -> torch.Tensor:
    """Gold scoring shared by both NMT families: teacher-forced outputs,
    log-softmax of the generator, the gold tokens' log-probabilities with
    PAD positions zeroed, summed over time."""
    outs = model.forward(src_ids, src_lengths, tgt_ids)[0]
    lp = torch.log_softmax(model.generator_logits(outs), dim=-1)
    gold = tgt_ids[:, 1:].long()
    tok = torch.gather(lp, -1, gold[..., None])[..., 0]
    return torch.sum(torch.where(gold != C.PAD, tok, torch.zeros_like(tok)),
                     dim=-1)
