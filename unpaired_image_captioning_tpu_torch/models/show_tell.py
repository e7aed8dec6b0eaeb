"""Show-and-tell and all_img: plain stacked-LSTM decoders (counterpart of
`unpaired_image_captioning_tpu/models/show_tell.py`).

- `ShowTellModel`: the image fed once through `img_embed` in
  `make_decoder`, word embedding, a stacked LSTM core (num_layers, dropout
  between layers), dropout on the top hidden state, logit;
- `AllImgModel`: the initial state h = c from `img_linear(fc)`, and the raw
  fc feature concatenated to every step's word input.

Every cell is `ops.rnn.stacked_lstm_step` (the fused G=4 kernel on CUDA).
States are `(h[B,L,H], c[B,L,H])`.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops import rnn
from .base import (CaptionDecoder, Features, dropout, embedding_init,
                   init_embedding, linear, linear_init)


class _StackedLSTMDecoder(CaptionDecoder):
    """The shared layout: `first` (img_embed or img_linear), embed, core,
    logit at scale 0.1."""

    def __init__(self, *, vocab_size: int, input_encoding_size: int,
                 rnn_size: int, num_layers: int, drop_prob_lm: float,
                 seq_length: int, fc_feat_size: int, device=None):
        super().__init__(vocab_size=vocab_size,
                         input_encoding_size=input_encoding_size,
                         rnn_size=rnn_size, num_layers=num_layers,
                         drop_prob_lm=drop_prob_lm, seq_length=seq_length,
                         fc_feat_size=fc_feat_size)
        self.first_init(device)
        self.embed = embedding_init(vocab_size + 1, input_encoding_size,
                                    device=device)
        self.core = rnn.init_stacked_lstm(num_layers, self.core_input_size,
                                          rnn_size, device=device)
        self.logit = linear_init(rnn_size, vocab_size + 1, scale=0.1,
                                 device=device)

    def init_params(self, generator: torch.Generator):
        self.first.init_params(generator)
        init_embedding(self.embed, generator)
        for cell in self.core:
            cell.init_params(generator)
        self.logit.init_params(generator)
        return self

    def _stacked(self, xt, state, training, generator):
        h, c = state
        top, hs, cs = rnn.stacked_lstm_step(
            self.core, xt, h.transpose(0, 1), c.transpose(0, 1),
            generator=generator if training else None,
            dropout=self.drop_prob_lm)
        out = dropout(top, self.drop_prob_lm, training, generator)
        return out, (hs.transpose(0, 1), cs.transpose(0, 1))

    def head(self, h, *, training: bool = False,
             generator: Optional[torch.Generator] = None):
        return torch.log_softmax(linear(self.logit, h), dim=-1)


class ShowTellModel(_StackedLSTMDecoder):
    @property
    def core_input_size(self) -> int:
        return self.input_encoding_size

    @property
    def first(self):
        return self.img_embed

    def first_init(self, device) -> None:
        self.img_embed = linear_init(self.fc_feat_size,
                                     self.input_encoding_size, device=device)

    def make_decoder(self, feats: Features, *, training: bool = False,
                     generator: Optional[torch.Generator] = None):
        fc = feats.fc_feats
        z = torch.zeros((fc.shape[0], self.num_layers, self.rnn_size),
                        dtype=fc.dtype, device=fc.device)
        _, state = self._stacked(linear(self.img_embed, fc), (z, z),
                                 training, generator)
        return None, state

    def step_core(self, ctx, state, it, *, training: bool = False,
                  generator: Optional[torch.Generator] = None):
        return self._stacked(self.embed[it], state, training, generator)


class AllImgModel(_StackedLSTMDecoder):
    """all_img: the raw fc feature concatenated to every step's word input,
    and the initial hidden state from the image."""

    @property
    def core_input_size(self) -> int:
        return self.input_encoding_size + self.fc_feat_size

    @property
    def first(self):
        return self.img_linear

    def first_init(self, device) -> None:
        self.img_linear = linear_init(self.fc_feat_size,
                                      self.num_layers * self.rnn_size,
                                      device=device)

    def make_decoder(self, feats: Features, *, training: bool = False,
                     generator: Optional[torch.Generator] = None):
        fc = feats.fc_feats
        img = linear(self.img_linear, fc).reshape(
            fc.shape[0], self.num_layers, self.rnn_size)
        return {"fc": fc}, (img, img)

    def step_core(self, ctx, state, it, *, training: bool = False,
                  generator: Optional[torch.Generator] = None):
        xt = torch.cat([self.embed[it], ctx["fc"]], -1)
        return self._stacked(xt, state, training, generator)
