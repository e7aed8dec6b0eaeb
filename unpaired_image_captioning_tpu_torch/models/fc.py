"""FC captioner: an fc-feature-conditioned maxout-LSTM decoder (counterpart
of `unpaired_image_captioning_tpu/models/fc.py`, the reference's
`FCModel_NMT`, wired for ``--caption_model fc``).

- the image is fed once, through `img_embed`, in `make_decoder`;
- the core is one maxout (G=5) cell, `ops.rnn.lstm_step` (the fused kernel
  on CUDA), with dropout on its hidden output;
- `logit` (initialised at scale 0.1) to vocab_size + 1 and log_softmax.

`ctx` is None and the state is `(h[B,H], c[B,H])`.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops import rnn
from .base import (CaptionDecoder, Features, dropout, embedding_init,
                   init_embedding, linear, linear_init)


class FCModel(CaptionDecoder):
    def __init__(self, *, vocab_size: int, input_encoding_size: int,
                 rnn_size: int, num_layers: int, drop_prob_lm: float,
                 seq_length: int, fc_feat_size: int, device=None):
        super().__init__(vocab_size=vocab_size,
                         input_encoding_size=input_encoding_size,
                         rnn_size=rnn_size, num_layers=num_layers,
                         drop_prob_lm=drop_prob_lm, seq_length=seq_length,
                         fc_feat_size=fc_feat_size)
        e = input_encoding_size
        self.img_embed = linear_init(fc_feat_size, e, device=device)
        self.embed = embedding_init(vocab_size + 1, e, device=device)
        self.core = rnn.init_lstm_params(e, rnn_size, maxout=True,
                                         device=device)
        self.logit = linear_init(rnn_size, vocab_size + 1, scale=0.1,
                                 device=device)

    def init_params(self, generator: torch.Generator) -> "FCModel":
        self.img_embed.init_params(generator)
        init_embedding(self.embed, generator)
        self.core.init_params(generator)
        self.logit.init_params(generator)
        return self

    def _core(self, xt, state, *, training: bool, generator):
        h_new, c_new = rnn.lstm_step(self.core, xt, *state, maxout=True)
        out = dropout(h_new, self.drop_prob_lm, training, generator)
        return out, (h_new, c_new)

    def make_decoder(self, feats: Features, *, training: bool = False,
                     generator: Optional[torch.Generator] = None):
        fc = feats.fc_feats
        h0 = torch.zeros((fc.shape[0], self.rnn_size), dtype=fc.dtype,
                         device=fc.device)
        xt = linear(self.img_embed, fc)
        _, state = self._core(xt, (h0, h0), training=training,
                              generator=generator)
        return None, state

    def step_core(self, ctx, state, it, *, training: bool = False,
                  generator: Optional[torch.Generator] = None):
        return self._core(self.embed[it], state, training=training,
                          generator=generator)

    def head(self, h, *, training: bool = False,
             generator: Optional[torch.Generator] = None):
        return torch.log_softmax(linear(self.logit, h), dim=-1)
