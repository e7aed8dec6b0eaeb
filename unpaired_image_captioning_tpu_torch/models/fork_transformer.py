"""The vendored OpenNMT fork's post-norm transformer (counterpart of
`unpaired_image_captioning_tpu/models/fork_transformer.py`).

The production transformer NMT is `models/nmt_transformer.py` (pre-norm,
with the decoder-step kernel). This module is the fork's
`-encoder_layer transformer -decoder_layer transformer` model, an older
architecture with these semantics, each kept as the JAX package pins it:

- post-norm: the LayerNorm runs at the end of each sublayer and lives
  inside the attention and FFN modules;
- the fork's LayerNorm takes the unbiased std (n - 1) and adds eps 1e-3
  outside the sqrt;
- q / k / v carry no bias and there is no output projection: the heads'
  concatenated context feeds the residual directly, and that residual is
  the query before its projection;
- masked scores are -inf, so a source row that is all PAD gives NaN in
  the context attention, as in JAX;
- the positional encoding is the fork's per-index formula:
  pe[j, i] = sin(j / 10000^(2i/d)) on even i, cos(...) on odd i;
- `translate_greedy` re-runs the whole grown prefix every step (the fork
  has no KV cache), as a host loop, and returns [B, max_len - 1] with PAD
  after EOS.

The JAX package computes this model in XLA, so the port computes it in
plain torch ops; the transformer kernels compute the pre-norm model and
do not serve this one. Parameter names follow the JAX tree
(`enc.{i}.self.q.w`, `dec.{i}.src.ln.a_2`, `generator.w`, ...), so

    model.load_state_dict(bridge.params_from_jax(jax_params))

carries JAX weights across, and a fork checkpoint comes in through
`models/convert.py::convert_fork_transformer`:

    model = ForkTransformerNMT.from_fork_state_dict(state, device="cuda")
"""

from __future__ import annotations

import math
import re
from typing import Optional

import torch
from torch import nn

from .. import constants as C
from .base import Linear, resolve_device

FORK_LN_EPS = 1e-3


class ForkLayerNorm(nn.Module):
    """`a_2` [d] (gain) and `b_2` [d] (bias) of the fork's LayerNorm."""

    def __init__(self, dim: int, *, device=None):
        super().__init__()
        self.a_2 = nn.Parameter(torch.ones((dim,), device=device))
        self.b_2 = nn.Parameter(torch.zeros((dim,), device=device))


def fork_layer_norm(p: ForkLayerNorm, z: torch.Tensor,
                    eps: float = FORK_LN_EPS) -> torch.Tensor:
    """onmt/modules/Util.py:29-52: unbiased std, eps outside the sqrt."""
    mu = z.mean(-1, keepdim=True)
    var = torch.square(z - mu).sum(-1, keepdim=True) / (z.shape[-1] - 1)
    return (z - mu) / (torch.sqrt(var) + eps) * p.a_2 + p.b_2


def fork_positional_encoding(max_len: int, dim: int, *,
                             device=None) -> torch.Tensor:
    """onmt/Models.py:128-134: the i-th channel's frequency is 2i/dim, sin
    on even channels and cos on odd ones. [max_len, dim] f32."""
    j = torch.arange(max_len, dtype=torch.float32, device=device)[:, None]
    i = torch.arange(dim, dtype=torch.float32, device=device)[None, :]
    k = j / torch.pow(torch.tensor(10000.0, device=device), 2.0 * i / dim)
    odd = (torch.arange(dim, device=device) % 2 == 1)[None, :]
    return torch.where(odd, torch.cos(k), torch.sin(k))


class ForkMHA(nn.Module):
    """Bias-free q / k / v projections and the post-norm LayerNorm."""

    def __init__(self, d_model: int, *, device=None):
        super().__init__()
        self.q = Linear(d_model, d_model, bias=False, device=device)
        self.k = Linear(d_model, d_model, bias=False, device=device)
        self.v = Linear(d_model, d_model, bias=False, device=device)
        self.ln = ForkLayerNorm(d_model, device=device)


class ForkFFN(nn.Module):
    """w_1 / w_2 with biases and the post-norm LayerNorm."""

    def __init__(self, d_model: int, d_inner: int, *, device=None):
        super().__init__()
        self.w1 = Linear(d_model, d_inner, device=device)
        self.w2 = Linear(d_inner, d_model, device=device)
        self.ln = ForkLayerNorm(d_model, device=device)


def fork_mha_apply(p: ForkMHA, key, value, query, mask, *, n_heads: int):
    """MultiHeadedAttn.py:29-88. key / value / query [B, L, d]; mask
    [B, Lq, Lk] bool, True = masked. Returns (the residual of the
    pre-projection query, post-normed, and the post-softmax weights
    [B, h, Lq, Lk])."""
    d = query.shape[-1]
    dh = d // n_heads

    def split(x, w):
        b, l, _ = x.shape
        return (x @ w).reshape(b, l, n_heads, dh)

    k_up = split(key, p.k.w)
    v_up = split(value, p.v.w)
    q_up = split(query, p.q.w)
    scaled = torch.einsum("bqhd,bkhd->bhqk", q_up, k_up) / math.sqrt(dh)
    if mask is not None:
        scaled = scaled.masked_fill(mask[:, None, :, :], float("-inf"))
    attn = torch.softmax(scaled, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", attn, v_up).reshape(query.shape)
    return fork_layer_norm(p.ln, out + query), attn


def fork_ffn_apply(p: ForkFFN, x):
    """Transformer.py:32-45: relu(x w_1 + b_1) w_2 + b_2, residual, then
    the LayerNorm."""
    h = torch.relu(x @ p.w1.w + p.w1.b)
    return fork_layer_norm(p.ln, h @ p.w2.w + p.w2.b + x)


def _pad_mask(q_ids, k_ids):
    """Transformer.py:12-21: [B, Lq, Lk] True where the KEY token is PAD."""
    b, lk = k_ids.shape
    return (k_ids == C.PAD)[:, None, :].expand(b, q_ids.shape[1], lk)


def fork_enc_layer_apply(lp: nn.ModuleDict, x, words, *, n_heads: int):
    """Transformer.py:48-69: self-attention under the PAD mask, then the
    FFN."""
    mid, _ = fork_mha_apply(lp["self"], x, x, x, _pad_mask(words, words),
                            n_heads=n_heads)
    return fork_ffn_apply(lp["ffn"], mid)


def fork_dec_layer_apply(lp: nn.ModuleDict, x, context, src_words,
                         tgt_words, *, n_heads: int):
    """Transformer.py:72-110: self-attention under the PAD and subsequent
    mask, then the context attention (key = value = context, query = the
    self-attention's output), then the FFN. Returns (out, attn)."""
    t = tgt_words.shape[1]
    sub = torch.triu(torch.ones((t, t), dtype=torch.bool,
                                device=x.device), diagonal=1)[None]
    dec_mask = _pad_mask(tgt_words, tgt_words) | sub
    query, _ = fork_mha_apply(lp["self"], x, x, x, dec_mask, n_heads=n_heads)
    mid, attn = fork_mha_apply(lp["src"], context, context, query,
                               _pad_mask(tgt_words, src_words),
                               n_heads=n_heads)
    return fork_ffn_apply(lp["ffn"], mid), attn


class ForkTransformerNMT(nn.Module):
    """The fork's transformer NMT, batch first (the fork's length-first
    tensors are transposed at its module boundaries)."""

    def __init__(self, src_vocab_size: int, tgt_vocab_size: int,
                 d_model: int = 512, d_inner: int = 2048,
                 num_layers: int = 6, num_heads: int = 8,
                 position_encoding: bool = True, max_len: int = 5000, *,
                 device="cuda"):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} is not divisible by "
                             f"{num_heads} heads")
        device = resolve_device(device)
        self.src_vocab_size = src_vocab_size
        self.tgt_vocab_size = tgt_vocab_size
        self.d_model, self.d_inner = d_model, d_inner
        self.num_layers, self.num_heads = num_layers, num_heads
        self.position_encoding, self.max_len = position_encoding, max_len
        self.src_embed = nn.Parameter(torch.zeros(
            (src_vocab_size, d_model), device=device))
        self.tgt_embed = nn.Parameter(torch.zeros(
            (tgt_vocab_size, d_model), device=device))
        self.generator = Linear(d_model, tgt_vocab_size, device=device)
        self.enc = nn.ModuleList(
            nn.ModuleDict({"self": ForkMHA(d_model, device=device),
                           "ffn": ForkFFN(d_model, d_inner, device=device)})
            for _ in range(num_layers))
        self.dec = nn.ModuleList(
            nn.ModuleDict({"self": ForkMHA(d_model, device=device),
                           "src": ForkMHA(d_model, device=device),
                           "ffn": ForkFFN(d_model, d_inner, device=device)})
            for _ in range(num_layers))

    @property
    def device(self) -> torch.device:
        return self.src_embed.device

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "ForkTransformerNMT":
        """The JAX init's distributions from `generator` (a CPU generator):
        weights normal / sqrt(in), embeddings normal x 0.1, biases 0,
        LayerNorm gains 1."""
        def normal(shape):
            return torch.randn(shape, generator=generator).to(self.device)

        self.src_embed.copy_(normal(self.src_embed.shape) * 0.1)
        self.tgt_embed.copy_(normal(self.tgt_embed.shape) * 0.1)
        for m in self.modules():
            if isinstance(m, Linear):
                m.w.copy_(normal(m.w.shape) / math.sqrt(m.in_dim))
                if m.b is not None:
                    m.b.zero_()
            elif isinstance(m, ForkLayerNorm):
                m.a_2.fill_(1.0)
                m.b_2.zero_()
        return self

    @classmethod
    def from_fork_state_dict(cls, state: dict, *, num_heads: int = 8,
                             position_encoding: bool = True,
                             device="cuda") -> "ForkTransformerNMT":
        """A fork checkpoint's state dict (name -> array) through
        `convert_fork_transformer`; the widths, vocabularies and depth are
        read from its shapes."""
        import numpy as np

        from ..bridge import params_from_jax
        from .convert import convert_fork_transformer

        layers = {int(m.group(1)) for k in state
                  for m in [re.match(r"encoder\.transformer\.(\d+)\.", k)]
                  if m}
        src = np.asarray(state["encoder.embeddings.word_lut.weight"])
        tgt = np.asarray(state["decoder.embeddings.word_lut.weight"])
        w1 = np.asarray(state["encoder.transformer.0.feed_forward.w_1.weight"])
        model = cls(src.shape[0], tgt.shape[0], d_model=src.shape[1],
                    d_inner=w1.shape[0], num_layers=len(layers),
                    num_heads=num_heads,
                    position_encoding=position_encoding, device=device)
        model.load_state_dict(params_from_jax(
            convert_fork_transformer(state, num_layers=len(layers))))
        return model

    def _embed(self, table, ids):
        emb = table[ids]
        if self.position_encoding:
            emb = emb + fork_positional_encoding(
                ids.shape[1], self.d_model, device=emb.device)[None]
        return emb

    def encode(self, src_ids):
        """onmt/Models.py:257-261: the embedding, then the encoder layers
        (no final norm: post-norm layers end normalised)."""
        x = self._embed(self.src_embed, src_ids)
        for lp in self.enc:
            x = fork_enc_layer_apply(lp, x, src_ids, n_heads=self.num_heads)
        return x

    def decode(self, context, src_ids, tgt_ids):
        """onmt/Models.py:406-424: the full-prefix decoder stack. Returns
        (outputs [B, T, d], the last layer's attention [B, h, T, S])."""
        x = self._embed(self.tgt_embed, tgt_ids)
        attn: Optional[torch.Tensor] = None
        for lp in self.dec:
            x, attn = fork_dec_layer_apply(lp, x, context, src_ids, tgt_ids,
                                           n_heads=self.num_heads)
        return x, attn

    def forward(self, src_ids, tgt_ids):
        """Teacher forcing: (logprobs [B, T, tgt_vocab] over the generator,
        the last layer's attention)."""
        out, attn = self.decode(self.encode(src_ids), src_ids, tgt_ids)
        logits = out @ self.generator.w + self.generator.b
        return torch.log_softmax(logits, dim=-1), attn

    @torch.no_grad()
    def translate_greedy(self, src_ids, max_len: int = 50) -> torch.Tensor:
        """Greedy decode that re-decodes the whole grown prefix each step
        and reads its last position (onmt/Models.py:386-388,419-423), as a
        host loop. Returns [B, max_len - 1] int64, PAD after EOS."""
        b = src_ids.shape[0]
        ctxv = self.encode(src_ids)
        prefix = torch.full((b, max_len), C.PAD, dtype=torch.long,
                            device=src_ids.device)
        prefix[:, 0] = C.BOS
        done = torch.zeros((b,), dtype=torch.bool, device=src_ids.device)
        toks = []
        for t in range(max_len - 1):
            out, _ = self.decode(ctxv, src_ids, prefix[:, :t + 1])
            logits = out[:, -1] @ self.generator.w + self.generator.b
            nxt = torch.argmax(logits, dim=-1)
            nxt = torch.where(done, torch.full_like(nxt, C.PAD), nxt)
            toks.append(nxt)
            done = done | (nxt == C.EOS)
            prefix[:, t + 1] = nxt
        return torch.stack(toks, dim=1)
