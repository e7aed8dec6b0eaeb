"""StackCap: a coarse-to-fine three-stage captioner with attribute
features (counterpart of `unpaired_image_captioning_tpu/models/stackcap.py`).

The AttModel embeddings plus `attri_embed` (a Linear without bias, ReLU
and dropout) over the 1,601-wide box class-probability vector; a missing
`attri_feats` counts as zeros. The core: three maxout LSTMs
(`ops.rnn.lstm_step`, the fused kernel on CUDA) and two attentions; lstm1
and lstm2 take `xt + attri_emb` beside the stacked hiddens and attention
results; `att2` reads `h1` directly (StackAtt's `h1d + emb2(att1)` and its
step fusion do not apply). The core gives the heads `[h0, h1,
fusion2([h0, h1, h2])]` of one shared logit: `forward` returns the three
[B, T, V+1] logprob tensors, whose XE losses sum; decoding uses the last.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops import rnn
from ..ops.sampling import gumbel_argmax
from .att import AttModel, attention_apply, attention_init
from .base import Features, dropout, linear, linear_init


class StackCapModel(AttModel):
    def __init__(self, *, vocab_size: int, input_encoding_size: int,
                 rnn_size: int, num_layers: int, drop_prob_lm: float,
                 seq_length: int, fc_feat_size: int,
                 att_feat_size: int = 2048, att_hid_size: int = 512,
                 use_bn: int = 0, logit_layers: int = 1,
                 attri_feat_size: int = 1601, attri_hid_size: int = 512,
                 device=None):
        self.attri_feat_size = attri_feat_size
        self.attri_hid_size = attri_hid_size
        super().__init__(vocab_size=vocab_size,
                         input_encoding_size=input_encoding_size,
                         rnn_size=rnn_size, num_layers=num_layers,
                         drop_prob_lm=drop_prob_lm, seq_length=seq_length,
                         fc_feat_size=fc_feat_size,
                         att_feat_size=att_feat_size,
                         att_hid_size=att_hid_size, use_bn=use_bn,
                         logit_layers=logit_layers, device=device)

    @property
    def eff_num_layers(self) -> int:
        return 3

    def extra_init(self, device) -> None:
        self.attri_embed = linear_init(self.attri_feat_size,
                                       self.input_encoding_size, bias=False,
                                       device=device)

    def core_init(self, device) -> nn.ModuleDict:
        h = self.rnn_size
        e = self.input_encoding_size
        return nn.ModuleDict({
            "lstm0": rnn.init_lstm_params(e + h, h, maxout=True,
                                          device=device),
            "lstm1": rnn.init_lstm_params(e + 2 * h, h, maxout=True,
                                          device=device),
            "lstm2": rnn.init_lstm_params(e + 2 * h, h, maxout=True,
                                          device=device),
            "att1": attention_init(h, self.att_hid_size, device=device),
            "att2": attention_init(h, self.att_hid_size, device=device),
            "fusion1": linear_init(2 * h, h, device=device),
            "fusion2": linear_init(3 * h, h, device=device),
        })

    def make_decoder(self, feats: Features, *, training: bool = False,
                     generator: Optional[torch.Generator] = None,
                     aux_out: Optional[dict] = None):
        ctx, state = super().make_decoder(feats, training=training,
                                          generator=generator,
                                          aux_out=aux_out)
        attri = feats.attri_feats
        if attri is None:
            fc = feats.fc_feats
            attri = torch.zeros((fc.shape[0], self.attri_feat_size),
                                dtype=fc.dtype, device=fc.device)
        ctx["attri"] = dropout(torch.relu(linear(self.attri_embed, attri)),
                               self.drop_prob_lm, training, generator)
        return ctx, state

    def _core_heads(self, xt, ctx, state, *, training, generator):
        p = self.core
        h, c = state
        rate = self.drop_prob_lm
        h0, c0 = rnn.lstm_step(p["lstm0"], torch.cat([xt, ctx["fc"]], -1),
                               h[:, 0], c[:, 0], maxout=True)
        att1 = attention_apply(p["att1"], h0, ctx["att"], ctx["p_att"],
                               ctx["masks"], training=training)
        xa = xt + ctx["attri"]
        h1, c1 = rnn.lstm_step(p["lstm1"], torch.cat([xa, h0, att1], -1),
                               h[:, 1], c[:, 1], maxout=True)
        att2 = attention_apply(p["att2"], h1, ctx["att"], ctx["p_att"],
                               ctx["masks"], training=training)
        fused01 = dropout(torch.relu(
            linear(p["fusion1"], torch.cat([h0, h1], -1))), rate, training,
            generator)
        h2, c2 = rnn.lstm_step(p["lstm2"], torch.cat([xa, fused01, att2], -1),
                               h[:, 2], c[:, 2], maxout=True)
        final = dropout(torch.relu(
            linear(p["fusion2"], torch.cat([h0, h1, h2], -1))), rate,
            training, generator)
        return [h0, h1, final], (torch.stack([h0, h1, h2], 1),
                                 torch.stack([c0, c1, c2], 1))

    def core_step(self, xt, ctx, state, *, training, generator):
        heads, state = self._core_heads(xt, ctx, state, training=training,
                                        generator=generator)
        return heads[-1], state   # decoding uses the final head

    def forward(self, feats: Features, seq: torch.Tensor, *,
                training: bool = False,
                generator: Optional[torch.Generator] = None,
                ss_prob: float = 0.0, ss_enabled: Optional[bool] = None,
                aux_out: Optional[dict] = None) -> list:
        """Three-headed teacher forcing: a list of three [B, L-1, V+1]
        logprob tensors (coarse, fine, final) for the summed loss. Scheduled
        sampling as `CaptionDecoder.forward`, drawing from the final
        head."""
        if ss_enabled is None:
            ss_enabled = ss_prob > 0
        use_ss = training and ss_enabled
        if use_ss and generator is None:
            raise ValueError("scheduled sampling draws from a generator")
        ctx, state = self.make_decoder(feats, training=training,
                                       generator=generator, aux_out=aux_out)
        batch = seq.shape[0]
        outs = ([], [], [])
        prev = None
        for t in range(seq.shape[1] - 1):
            it = seq[:, t]
            if use_ss and t > 0:
                coin = torch.rand((batch,), generator=generator,
                                  device=seq.device) < ss_prob
                sampled = gumbel_argmax(prev, generator).to(it.dtype)
                it = torch.where(coin, sampled, it)
            xt = dropout(torch.relu(self.embed[it]), self.drop_prob_lm,
                         training, generator)
            heads, state = self._core_heads(xt, ctx, state,
                                            training=training,
                                            generator=generator)
            lps = [self.head(hd, training=training, generator=generator)
                   for hd in heads]
            prev = lps[-1].detach()
            for o, lp in zip(outs, lps):
                o.append(lp)
        return [torch.stack(o, 1) for o in outs]


# ---------------------------------------------------------------------------
# auxiliary modules shipped beside StackCap in the reference
# ---------------------------------------------------------------------------

def bilinear_d3_init(x_dim: int, y_dim: int, *, device=None):
    """Bilinear scoring `score[b, o] = x[b] @ W @ y[b, o]` over a 3-D
    candidate tensor; W ~ uniform(+-1/sqrt(x_dim)), kept as `w` (no
    bias)."""
    return linear_init(x_dim, y_dim, bias=False, device=device)


def bilinear_d3_apply(p, x, y):
    """x: [B, Dx]; y: [B, O, Dy] -> scores [B, O]."""
    return torch.einsum("bd,bod->bo", x @ p.w, y)


def sentence_attention_init(rnn_size: int, att_hid: int, *, device=None):
    """Additive attention over previously generated hidden states."""
    return attention_init(rnn_size, att_hid, device=device)


def sentence_attention_apply(p, h, hist, hist_mask, training: bool = False):
    """h: [B, H] query; hist: [B, T, H] past hiddens; hist_mask: [B, T]."""
    p_hist = linear(p["h2att"], hist)   # projected like ctx2att
    return attention_apply(p, h, hist, p_hist, hist_mask, training=training)
