"""Transformer NMT, the zh->en transformer recipe (counterpart of
`unpaired_image_captioning_tpu/models/nmt_transformer.py`).

It shares the attention, FFN and LayerNorm primitives with the caption
transformer (`models/transformer.py`) and has the interface of the
recurrent `NMTModel` (`forward`, `generator_logits`, `translate_batch(src,
lengths, *, beam_size, max_len)`), so `pivot_translate` and `PivotService`
take either. `make_nmt_model(cfg)` chooses by `cfg.nmt_model_type`.

`translate_batch` runs the OpenNMT beam (`onmt_beam_search`) with every
decode step in one call of the decoder-step kernel (`decoder_stack_step`,
the plain version on the CPU), with the last layer's mean-head cross-
attention weights as the UNK-replacement signal. The K/V caches are lazy:
rows are append-only, written in place by the kernel, and read through the
beam's ancestry table (`anc`) instead of being reordered each step.

`forward(..., training=True, generator=...)` trains through the caption
transformer's training routes (`models/transformer.py`: whole encoder
layers by default, the flags `TRAIN_LAYER_KERNEL` and
`TRAIN_DEC_LAYER_KERNEL` choosing as there), with the embedding dropout at
`dropout` and the layers' at `transformer.DROPOUT`. The JAX package sends
this encoder (d_ff 2048) to its sublayer route, where the TPU's VMEM
cannot hold the whole layer; the port sends it to the whole-layer kernel.
Only the dropout stream differs.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from .. import constants as C
from ..kernels.transformer_decode import decoder_stack_step
from ..ops.transformer_decode import pack_stack_weights, src_mask_2d
from .base import dropout, init_module, linear, linear_init, resolve_device
from .nmt import NMTModel, _gold_scores
from .transformer import (LayerNorm, dec_layer_apply, dec_layer_init,
                          enc_layer_apply, enc_layer_init, layer_norm,
                          positional_encoding)


class _GeneratorBias(nn.Module):
    """The generator under `share_decoder_embeddings`: a bias only (the
    weight is tgt_embed transposed)."""

    def __init__(self, vocab: int, *, device=None):
        super().__init__()
        self.b = nn.Parameter(torch.empty((vocab,), device=device))

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        self.b.zero_()


class TransformerNMTModel(nn.Module):
    def __init__(self, src_vocab_size: int, tgt_vocab_size: int,
                 d_model: int = 512, d_ff: int = 2048, num_layers: int = 6,
                 num_heads: int = 8, dropout: float = 0.1,
                 share_decoder_embeddings: bool = False,
                 max_decode_len: int = 100, beam_size: int = 15, *,
                 device=None):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} is not divisible by "
                             f"{num_heads} heads")
        self.src_vocab_size, self.tgt_vocab_size = src_vocab_size, tgt_vocab_size
        self.d_model, self.d_ff = d_model, d_ff
        self.num_layers, self.num_heads = num_layers, num_heads
        self.dropout = dropout
        self.share_decoder_embeddings = share_decoder_embeddings
        self.max_decode_len, self.beam_size = max_decode_len, beam_size
        self.src_embed = nn.Parameter(torch.empty((src_vocab_size, d_model),
                                                  device=device))
        self.tgt_embed = nn.Parameter(torch.empty((tgt_vocab_size, d_model),
                                                  device=device))
        self.enc_norm = LayerNorm(d_model, device=device)
        self.dec_norm = LayerNorm(d_model, device=device)
        self.enc = nn.ModuleList([enc_layer_init(d_model, d_ff, device=device)
                                  for _ in range(num_layers)])
        self.dec = nn.ModuleList([dec_layer_init(d_model, d_ff, device=device)
                                  for _ in range(num_layers)])
        self.generator = (_GeneratorBias(tgt_vocab_size, device=device)
                          if share_decoder_embeddings else
                          linear_init(d_model, tgt_vocab_size, device=device))

    @classmethod
    def from_config(cls, cfg, *, device="cuda") -> "TransformerNMTModel":
        """Build from a config object, on the card unless `device` names
        another."""
        return cls(src_vocab_size=cfg.nmt_src_vocab_size,
                   tgt_vocab_size=cfg.nmt_tgt_vocab_size,
                   d_model=cfg.word_vec_size, d_ff=cfg.rnn_size,
                   num_layers=cfg.layers, num_heads=cfg.num_heads,
                   dropout=cfg.dropout,
                   share_decoder_embeddings=cfg.share_decoder_embeddings,
                   device=resolve_device(device))

    @property
    def device(self) -> torch.device:
        return self.tgt_embed.device

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "TransformerNMTModel":
        """Embeddings normal * d^-0.5; linear layers uniform(+-1/sqrt(in))
        with zero bias; LayerNorms 1 / 0 (as the JAX init_params)."""
        init_module(self, generator)
        for table in (self.src_embed, self.tgt_embed):
            emb = torch.randn(table.shape, generator=generator,
                              device=generator.device)
            table.copy_(emb * self.d_model ** -0.5)
        return self

    def _embed(self, table, ids):
        """table[ids] * sqrt(d) with PAD rows zeroed, plus the positional
        encoding of each position."""
        d = self.d_model
        x = table[ids] * math.sqrt(d)
        x = x * (ids != C.PAD)[..., None].to(x.dtype)
        return x + positional_encoding(ids.shape[-1], d, device=x.device)[None]

    def encode(self, src_ids, lengths, *, training: bool = False,
               generator: Optional[torch.Generator] = None):
        """Pre-norm encoder stack. Returns (memory [B, S, d], src_mask
        [B, 1, S] bool)."""
        x = dropout(self._embed(self.src_embed, src_ids), self.dropout,
                    training, generator)
        s = src_ids.shape[-1]
        pos = torch.arange(s, device=src_ids.device)
        src_mask = (pos[None, :] < lengths[:, None])[:, None, :]
        for lp in self.enc:
            x = enc_layer_apply(lp, x, src_mask, self.num_heads,
                                training=training, generator=generator)
        return layer_norm(self.enc_norm, x, training=training), src_mask

    def generator_logits(self, output):
        if self.share_decoder_embeddings:
            return output @ self.tgt_embed.T + self.generator.b
        return linear(self.generator, output)

    def src_embedding(self) -> torch.Tensor:
        """The source word table (the Weight_Trans coupling point)."""
        return self.src_embed

    def tgt_embedding(self) -> torch.Tensor:
        """The target word table (the Weight_Trans_y coupling point)."""
        return self.tgt_embed

    def forward(self, src_ids, src_lengths, tgt_ids, *,
                training: bool = False,
                generator: Optional[torch.Generator] = None):
        """Parallel teacher forcing on tgt_ids[:, :-1]. Returns (decoder
        outputs [B, T-1, d], None), as NMTModel.forward. In training,
        dropout draws from `generator` (none without one)."""
        memory, src_mask = self.encode(src_ids, src_lengths,
                                       training=training, generator=generator)
        tgt_in = tgt_ids[:, :-1]
        x = dropout(self._embed(self.tgt_embed, tgt_in), self.dropout,
                    training, generator)
        pos = torch.arange(tgt_in.shape[-1], device=tgt_ids.device)
        causal = pos[None, :] <= pos[:, None]
        tgt_mask = (tgt_in != C.PAD)[:, None, :] & causal[None]
        for lp in self.dec:
            mk = linear(lp["src"]["k"], memory)
            mv = linear(lp["src"]["v"], memory)
            x = dec_layer_apply(lp, x, mk, mv, tgt_mask, src_mask,
                                self.num_heads, training=training,
                                generator=generator)
        return layer_norm(self.dec_norm, x, training=training), None

    def gold_scores(self, src_ids, src_lengths, tgt_ids) -> torch.Tensor:
        """Per-sentence gold log-likelihood, as NMTModel.gold_scores."""
        return _gold_scores(self, src_ids, src_lengths, tgt_ids)

    def make_decoder(self, src_ids, src_lengths, max_len: int):
        """(ctx, state0) of the incremental decode: the cross K/V [L, B, S,
        d], the packed decoder weights, the mask and the positional table in
        ctx; zero caches [B, L, T, d], t, the attention and the ancestry
        placeholder in state0."""
        memory, src_mask = self.encode(src_ids, src_lengths)
        b, slots, d = memory.shape
        dev = memory.device
        ctx = {"src_mask": src_mask_2d(src_mask, b, slots, dev),
               "pe": positional_encoding(max_len, d, device=dev),
               "wstack": pack_stack_weights(self.dec),
               "cross_k": torch.stack([linear(lp["src"]["k"], memory)
                                       for lp in self.dec]),
               "cross_v": torch.stack([linear(lp["src"]["v"], memory)
                                       for lp in self.dec])}
        zeros = torch.zeros((b, self.num_layers, max_len, d),
                            dtype=memory.dtype, device=dev)
        state0 = {"k": zeros, "v": zeros.clone(),
                  "t": torch.zeros((b,), dtype=torch.int32, device=dev),
                  "attn": torch.zeros((b, slots), dtype=torch.float32,
                                      device=dev),
                  "anc": torch.zeros((b, max_len), dtype=torch.int32,
                                     device=dev)}
        return ctx, state0

    def step(self, ctx, state, it):
        """One decode step: (logprobs [R, V], new state). The caches are
        written in place at slot t; `anc` (if any rows were reordered) names
        the row each position is read from."""
        t = state["t"]
        x = self.tgt_embed[it] * math.sqrt(self.d_model) + ctx["pe"][t.long()]
        x, k, v, attn = decoder_stack_step(
            x, t, ctx["cross_k"], ctx["cross_v"], ctx["src_mask"],
            state["k"], state["v"], ctx["wstack"], state["anc"],
            n_heads=self.num_heads, want_attn=True)
        logits = self.generator_logits(layer_norm(self.dec_norm, x))
        state = {"k": k, "v": v, "t": t + 1, "attn": attn,
                 "anc": state["anc"]}
        return torch.log_softmax(logits, dim=-1), state

    def translate_batch(self, src_ids, src_lengths, *,
                        beam_size: Optional[int] = None,
                        max_len: Optional[int] = None):
        """Beam-translate a batch. Returns BeamResult with seq [B, beam, T]
        (BOS excluded, EOS included) and aux = the per-step argmax of the
        last layer's mean-head source attention, for UNK replacement."""
        from ..ops.beam_search import onmt_beam_search

        beam_size = beam_size or self.beam_size
        max_len = max_len or self.max_decode_len
        ctx, state0 = self.make_decoder(src_ids, src_lengths, max_len)
        return onmt_beam_search(
            self.step, ctx, state0, beam_size=beam_size, seq_length=max_len,
            bos_token=C.BOS, eos_token=C.EOS,
            ctx_no_expand=("src_mask", "pe", "wstack", "cross_k", "cross_v"),
            record_aux_from_state=lambda st: st["attn"].argmax(dim=-1),
            lazy_state=("k", "v"), ancestry_key="anc")


def make_nmt_model(cfg, *, device="cuda"):
    """Factory: `cfg.nmt_model_type` "transformer" or "rnn" (the default),
    built on the card unless `device` names another."""
    if getattr(cfg, "nmt_model_type", "rnn") == "transformer":
        return TransformerNMTModel.from_config(cfg, device=device)
    return NMTModel.from_config(cfg, device=device)
