"""Transformer caption decoder over attention features (counterpart of
`unpaired_image_captioning_tpu/models/transformer.py`).

A pre-norm "Attention is All You Need" stack: N = `num_layers` layers,
d_model = `input_encoding_size`, d_ff = `rnn_size`, `num_heads` heads; the
att features are embedded by `att_embed` + ReLU and pass through the
encoder; the word embedding is scaled by sqrt(d_model) and a sinusoid
positional encoding is added. `use_bn` puts BatchNorm around `att_embed`
as in the LSTM family (`att.batch_norm`: batch moments over the real
slots in training, collected in `aux_out`; the running statistics
otherwise).

Training (`forward(..., training=True, generator=...)`) has three routes,
chosen by two module flags read at call time, as in the JAX module:

- `TRAIN_LAYER_KERNEL` True (the default): every encoder layer is one call
  of the whole-layer training kernel (`kernels/layer_train.py`,
  `enc_layer_train`), forward and backward; the decoder runs per sublayer.
- `TRAIN_DEC_LAYER_KERNEL` True as well: every decoder layer is one call
  of `dec_layer_train` too (the memory's K/V projections stay outside).
- `TRAIN_LAYER_KERNEL` False: every layer runs per sublayer. Each
  LayerNorm goes through the training LayerNorm kernel
  (`kernels/ln_train.py`) and each attention through the training
  attention kernel (`kernels/mha_train.py`).

The kernels draw their dropout inside from a seed taken from the caller's
`torch.Generator` (rate 0 without one); the other dropouts (after
`att_embed`, on the embedding and, per sublayer, on each residual branch
and inside the FFN) are drawn from the same generator by `base.dropout`.
Unlike the JAX module, which routes a layer to its kernel only where the
layer fits the TPU's VMEM (`enc_layer_kernel_ok`), the port routes every
training layer there and the kernel raises for a width it cannot take.

Incremental decode keeps a fixed-size K/V cache written at slot t. Every
step goes through the decoder-step kernel (`kernels/transformer_decode.py`,
the plain version on the CPU): by default `decoder_stack_step`, all L layers
in one call with caches `k_all`/`v_all` [b, L, T, d]; with the module flag
`STACK_KERNEL` False, `decoder_layer_step` once per layer with caches
`k{l}`/`v{l}` [b, T, d]. The cross-attention K/V are projected once per
sequence and stay at [B, ...], shared by the beams (`beam_ctx_no_expand`).
The kernels write the caches in place; the caption beam's `index_select`
reorder copies, so no step result is ever read back stale.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..kernels.layer_train import dec_layer_train, enc_layer_train
from ..kernels.ln_train import layer_norm_train
from ..kernels.mha_train import mha_train
from ..kernels.transformer_decode import (decoder_layer_step,
                                          decoder_stack_step)
from ..ops.transformer_decode import (NEG, cross_attend, layer_norm_plain,
                                      pack_layer_weights, pack_stack_weights,
                                      src_mask_2d)
from .att import BatchNorm, batch_norm
from .base import (CaptionDecoder, Features, dropout, init_module, linear,
                   linear_init)

DROPOUT = 0.1  # reference make_model default: attention, residual, FFN

# all L layers of a step in one kernel call; False: one call per layer
STACK_KERNEL = True

# each training encoder layer as one whole-layer kernel call; False: the
# per-sublayer route
TRAIN_LAYER_KERNEL = True
# each training decoder layer as one whole-layer kernel call too (live only
# with TRAIN_LAYER_KERNEL; off by default, as in the JAX module)
TRAIN_DEC_LAYER_KERNEL = False


def positional_encoding(max_len: int, d_model: int, *,
                        device=None) -> torch.Tensor:
    pos = torch.arange(max_len, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32,
                                 device=device)
                    * -(math.log(10000.0) / d_model))
    pe = torch.zeros((max_len, d_model), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


class LayerNorm(nn.Module):
    """`scale` [d] and `offset` [d], as layer_norm_init."""

    def __init__(self, dim: int, *, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.empty((dim,), device=device))
        self.offset = nn.Parameter(torch.empty((dim,), device=device))

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        self.scale.fill_(1.0)
        self.offset.zero_()


def layer_norm(p: LayerNorm, x: torch.Tensor, eps: float = 1e-6, *,
               training: bool = False):
    """The reference formula: scale * (x - mean) / (std + eps) + offset with
    the UNBIASED std (n-1 divisor) and eps outside the sqrt. In training it
    runs the training LayerNorm kernel (forward and backward)."""
    if training:
        return layer_norm_train(x, p.scale, p.offset, eps)
    return layer_norm_plain(x, p.scale, p.offset, eps)


def mha_init(d_model: int, *, device=None) -> nn.ModuleDict:
    return nn.ModuleDict({k: linear_init(d_model, d_model, device=device)
                          for k in ("q", "k", "v", "o")})


def ffn_init(d_model: int, d_ff: int, *, device=None) -> nn.ModuleDict:
    return nn.ModuleDict({"w1": linear_init(d_model, d_ff, device=device),
                          "w2": linear_init(d_ff, d_model, device=device)})


def enc_layer_init(d_model: int, d_ff: int, *, device=None) -> nn.ModuleDict:
    return nn.ModuleDict({
        "self": mha_init(d_model, device=device),
        "ffn": ffn_init(d_model, d_ff, device=device),
        "n1": LayerNorm(d_model, device=device),
        "n2": LayerNorm(d_model, device=device)})


def dec_layer_init(d_model: int, d_ff: int, *, device=None) -> nn.ModuleDict:
    return nn.ModuleDict({
        "self": mha_init(d_model, device=device),
        "src": mha_init(d_model, device=device),
        "ffn": ffn_init(d_model, d_ff, device=device),
        "n1": LayerNorm(d_model, device=device),
        "n2": LayerNorm(d_model, device=device),
        "n3": LayerNorm(d_model, device=device)})


def _split_heads(x, n_heads: int):
    b, t, d = x.shape
    return x.reshape(b, t, n_heads, d // n_heads)


def _seed(generator: Optional[torch.Generator], device) -> torch.Tensor:
    """One int32 in [0, 2^31 - 1) from the generator, on its device."""
    if generator is None:
        return torch.zeros((1,), dtype=torch.int32, device=device)
    return torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                         device=generator.device, dtype=torch.int32)


def _maskadd(mask, b: int, s: int, device) -> torch.Tensor:
    """The kernels' additive f32 mask from a bool [B, 1|T, S] mask (0 keep,
    -1e9 drop); [B, 1, S] zeros for None."""
    if mask is None:
        return torch.zeros((b, 1, s), device=device)
    return torch.where(mask, 0.0, NEG).to(torch.float32).contiguous()


def _rate(generator: Optional[torch.Generator]) -> float:
    """The kernels' dropout rate: DROPOUT, read at call time, with a
    generator; 0 without one."""
    return DROPOUT if generator is not None else 0.0


def mha_apply(p, q_in, k, v, mask, n_heads: int, *, training: bool = False,
              generator: Optional[torch.Generator] = None):
    """k, v: already-projected [B, S, d]; mask [B, 1|T, S] bool or None.
    In training the q projection runs here, the attention (with its dropout
    at rate DROPOUT when a generator is given) in the training kernel, and
    the o projection after it."""
    d = q_in.shape[-1]
    if training:
        maskadd = _maskadd(mask, q_in.shape[0], k.shape[1], q_in.device)
        out = mha_train(linear(p["q"], q_in), k.contiguous(), v.contiguous(),
                        maskadd, _seed(generator, q_in.device),
                        n_heads=n_heads, rate=_rate(generator))
        return linear(p["o"], out)
    q = _split_heads(linear(p["q"], q_in), n_heads)
    scores = torch.einsum("bthd,bshd->bhts", q, _split_heads(k, n_heads))
    scores = scores / math.sqrt(d // n_heads)
    if mask is not None:
        scores = torch.where(mask[:, None, :, :], scores,
                             torch.full_like(scores, NEG))
    attn = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhts,bshd->bthd", attn, _split_heads(v, n_heads))
    return linear(p["o"], out.reshape(q_in.shape[0], q_in.shape[1], d))


def ffn_apply(p, x, *, training: bool = False,
              generator: Optional[torch.Generator] = None):
    h = dropout(torch.relu(linear(p["w1"], x)), DROPOUT, training, generator)
    return linear(p["w2"], h)


def _packed_qkv(sp):
    """(wqkv [d, 3d], bqkv [3d]): the q, k and v projections packed on the
    output axis, as the JAX module packs them; autograd through the cat
    carries the gradients back to the separate parameters."""
    return (torch.cat([sp["q"].w, sp["k"].w, sp["v"].w], dim=1),
            torch.cat([sp["q"].b, sp["k"].b, sp["v"].b]))


def enc_layer_apply(lp, x, src_mask, n_heads: int, *, training: bool = False,
                    generator: Optional[torch.Generator] = None):
    """One pre-norm encoder layer (self-attention and FFN sublayers, each
    with its residual dropout in training); in training with
    TRAIN_LAYER_KERNEL, one call of the whole-layer kernel."""
    if training and TRAIN_LAYER_KERNEL:
        sp, ffn = lp["self"], lp["ffn"]
        wqkv, bqkv = _packed_qkv(sp)
        return enc_layer_train(
            x.contiguous(), _maskadd(src_mask, x.shape[0], x.shape[1],
                                     x.device),
            _seed(generator, x.device), wqkv, bqkv, sp["o"].w, sp["o"].b,
            ffn["w1"].w, ffn["w1"].b, ffn["w2"].w, ffn["w2"].b,
            lp["n1"].scale, lp["n1"].offset, lp["n2"].scale, lp["n2"].offset,
            n_heads=n_heads, rate=_rate(generator))
    kw = dict(training=training, generator=generator)
    y = layer_norm(lp["n1"], x, training=training)
    k = linear(lp["self"]["k"], y)
    v = linear(lp["self"]["v"], y)
    x = x + dropout(mha_apply(lp["self"], y, k, v, src_mask, n_heads, **kw),
                    DROPOUT, training, generator)
    y = layer_norm(lp["n2"], x, training=training)
    return x + dropout(ffn_apply(lp["ffn"], y, **kw), DROPOUT, training,
                       generator)


def dec_layer_apply(lp, x, mk, mv, tgt_mask, src_mask, n_heads: int, *,
                    training: bool = False,
                    generator: Optional[torch.Generator] = None):
    """One pre-norm decoder layer (self-attention, cross-attention and FFN
    sublayers, each with its residual dropout in training); mk/mv are the
    memory's K/V projections. In training with TRAIN_LAYER_KERNEL and
    TRAIN_DEC_LAYER_KERNEL, one call of the whole-layer kernel."""
    if training and TRAIN_LAYER_KERNEL and TRAIN_DEC_LAYER_KERNEL:
        sp, cp, ffn = lp["self"], lp["src"], lp["ffn"]
        wqkv, bqkv = _packed_qkv(sp)
        b, t = x.shape[0], x.shape[1]
        seed = _seed(generator, x.device)
        seeds = torch.cat([seed, seed ^ 0x55555555])
        return dec_layer_train(
            x.contiguous(), mk.contiguous(), mv.contiguous(),
            _maskadd(tgt_mask, b, t, x.device),
            _maskadd(src_mask, b, mk.shape[1], x.device), seeds, wqkv, bqkv,
            sp["o"].w, sp["o"].b, cp["q"].w, cp["q"].b, cp["o"].w, cp["o"].b,
            ffn["w1"].w, ffn["w1"].b, ffn["w2"].w, ffn["w2"].b,
            lp["n1"].scale, lp["n1"].offset, lp["n2"].scale, lp["n2"].offset,
            lp["n3"].scale, lp["n3"].offset, n_heads=n_heads,
            rate=_rate(generator))
    kw = dict(training=training, generator=generator)
    y = layer_norm(lp["n1"], x, training=training)
    k = linear(lp["self"]["k"], y)
    v = linear(lp["self"]["v"], y)
    x = x + dropout(mha_apply(lp["self"], y, k, v, tgt_mask, n_heads, **kw),
                    DROPOUT, training, generator)
    y = layer_norm(lp["n2"], x, training=training)
    x = x + dropout(mha_apply(lp["src"], y, mk, mv, src_mask, n_heads, **kw),
                    DROPOUT, training, generator)
    y = layer_norm(lp["n3"], x, training=training)
    return x + dropout(ffn_apply(lp["ffn"], y, **kw), DROPOUT, training,
                       generator)


def cross_attend_shared(p, y, ck, cv, src_mask, n_heads: int):
    """Cross-attention where the [B*K, 1, d] beam queries read UNEXPANDED
    [B, S, d] K/V: the beams of one image share the memory."""
    bsz, _, d = y.shape
    mask = src_mask_2d(src_mask, ck.shape[0], ck.shape[1], y.device)
    out, _ = cross_attend(linear(p["q"], y).reshape(bsz, d), ck, cv, mask,
                          n_heads)
    return linear(p["o"], out.reshape(bsz, 1, d))


class TransformerModel(CaptionDecoder):
    def __init__(self, *, vocab_size: int, input_encoding_size: int,
                 rnn_size: int, num_layers: int, drop_prob_lm: float,
                 seq_length: int, fc_feat_size: int,
                 att_feat_size: int = 2048, att_hid_size: int = 512,
                 use_bn: int = 0, logit_layers: int = 1, num_heads: int = 8,
                 device=None):
        super().__init__(vocab_size=vocab_size,
                         input_encoding_size=input_encoding_size,
                         rnn_size=rnn_size, num_layers=num_layers,
                         drop_prob_lm=drop_prob_lm, seq_length=seq_length,
                         fc_feat_size=fc_feat_size)
        d = input_encoding_size
        if d % num_heads:
            raise ValueError(f"d_model {d} is not divisible by {num_heads} "
                             "heads")
        self.att_feat_size = att_feat_size
        self.att_hid_size = att_hid_size
        self.logit_layers = logit_layers
        self.num_heads = num_heads
        self.use_bn = use_bn
        self.att_embed = linear_init(att_feat_size, d, device=device)
        # use_bn: BatchNorm around att_embed as in the LSTM family
        if use_bn:
            self.bn0 = BatchNorm(att_feat_size, device=device)
        if use_bn == 2:
            self.bn1 = BatchNorm(d, device=device)
        self.tgt_embed = nn.Parameter(torch.empty((vocab_size + 1, d),
                                                  device=device))
        self.generator = linear_init(d, vocab_size + 1, device=device)
        self.enc_norm = LayerNorm(d, device=device)
        self.dec_norm = LayerNorm(d, device=device)
        self.enc = nn.ModuleList([enc_layer_init(d, rnn_size, device=device)
                                  for _ in range(num_layers)])
        self.dec = nn.ModuleList([dec_layer_init(d, rnn_size, device=device)
                                  for _ in range(num_layers)])

    @property
    def d_model(self) -> int:
        return self.input_encoding_size

    @property
    def beam_ctx_no_expand(self) -> tuple:
        # the cross K/V, the mask, the packed weights and the positional
        # table are beam-invariant: [B, ...], shared by the K beams
        return ("cross", "src_mask", "wpack", "wstack", "cross_k", "cross_v",
                "pe")

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "TransformerModel":
        """Linear layers uniform(+-1/sqrt(in)) with zero bias, LayerNorms
        1 / 0, tgt_embed normal * d^-0.5, as the JAX init_params."""
        init_module(self, generator)
        emb = torch.randn(self.tgt_embed.shape, generator=generator,
                          device=generator.device)
        self.tgt_embed.copy_(emb * self.d_model ** -0.5)
        return self

    # ---- encoder ----
    def encode(self, feats: Features, *, training: bool = False,
               generator: Optional[torch.Generator] = None,
               aux_out: Optional[dict] = None):
        att = feats.att_feats
        if self.use_bn:
            att = batch_norm(self.bn0, att, training, mask=feats.att_masks,
                             aux_out=aux_out, key="bn0")
        x = dropout(torch.relu(linear(self.att_embed, att)),
                    self.drop_prob_lm, training, generator)
        if self.use_bn == 2:
            x = batch_norm(self.bn1, x, training, mask=feats.att_masks,
                           aux_out=aux_out, key="bn1")
        src_mask = (feats.att_masks[:, None, :] > 0
                    if feats.att_masks is not None else None)   # [B, 1, N]
        for lp in self.enc:
            x = enc_layer_apply(lp, x, src_mask, self.num_heads,
                                training=training, generator=generator)
        return layer_norm(self.enc_norm, x, training=training), src_mask

    # ---- parallel teacher forcing ----
    def forward(self, feats: Features, seq: torch.Tensor, *,
                training: bool = False,
                generator: Optional[torch.Generator] = None,
                aux_out: Optional[dict] = None) -> torch.Tensor:
        """Full parallel decode with causal + pad mask. seq [B, L] with the
        leading BOS column; returns logprobs [B, L-1, V+1]. In training,
        dropout draws from `generator` (none without one), and `aux_out`
        takes the `use_bn` batch moments."""
        memory, src_mask = self.encode(feats, training=training,
                                       generator=generator, aux_out=aux_out)
        seq_in = seq[:, :-1]
        t = seq_in.shape[1]
        d = self.d_model
        x = self.tgt_embed[seq_in] * math.sqrt(d)
        x = x + positional_encoding(t, d, device=x.device)[None]
        x = dropout(x, DROPOUT, training, generator)
        # pad mask: position 0 (the BOS slot, id 0) is always allowed
        pos = torch.arange(t, device=seq.device)
        pad_ok = (seq_in > 0) | (pos[None, :] == 0)                 # [B, T]
        causal = pos[None, :] <= pos[:, None]                        # [T, T]
        tgt_mask = pad_ok[:, None, :] & causal[None]                 # [B, T, T]
        for lp in self.dec:
            mk = linear(lp["src"]["k"], memory)
            mv = linear(lp["src"]["v"], memory)
            x = dec_layer_apply(lp, x, mk, mv, tgt_mask, src_mask,
                                self.num_heads, training=training,
                                generator=generator)
        logits = linear(self.generator,
                        layer_norm(self.dec_norm, x, training=training))
        return torch.log_softmax(logits, dim=-1)

    # ---- incremental decode with a fixed K/V cache ----
    def make_decoder(self, feats: Features, *, training: bool = False,
                     generator: Optional[torch.Generator] = None):
        memory, src_mask = self.encode(feats, training=training,
                                       generator=generator)
        b, slots, d = memory.shape
        n_t, n_l = self.seq_length, self.num_layers
        dev = memory.device
        ctx = {"src_mask": src_mask_2d(src_mask, b, slots, dev),
               "pe": positional_encoding(n_t, d, device=dev)}
        cross_k = [linear(lp["src"]["k"], memory) for lp in self.dec]
        cross_v = [linear(lp["src"]["v"], memory) for lp in self.dec]
        t0 = torch.zeros((b,), dtype=torch.int32, device=dev)
        if STACK_KERNEL:
            ctx["wstack"] = pack_stack_weights(self.dec)
            ctx["cross_k"] = torch.stack(cross_k)               # [L, B, S, d]
            ctx["cross_v"] = torch.stack(cross_v)
            zeros = torch.zeros((b, n_l, n_t, d), dtype=memory.dtype,
                                device=dev)
            return ctx, {"t": t0, "k_all": zeros, "v_all": zeros.clone()}
        ctx["wpack"] = [pack_layer_weights(lp) for lp in self.dec]
        ctx["cross"] = [{"k": k, "v": v} for k, v in zip(cross_k, cross_v)]
        state = {"t": t0}
        for li in range(n_l):
            state[f"k{li}"] = torch.zeros((b, n_t, d), dtype=memory.dtype,
                                          device=dev)
            state[f"v{li}"] = torch.zeros_like(state[f"k{li}"])
        return ctx, state

    def step(self, ctx, state, it, *, training: bool = False,
             generator: Optional[torch.Generator] = None):
        """One decode step; rows may sit at different positions (per-row
        t). The caches in `state` are written in place and returned. As in
        the JAX module, a decode step has no dropout (`training` is
        accepted and ignored)."""
        t = state["t"]
        x = self.tgt_embed[it] * math.sqrt(self.d_model) + ctx["pe"][t.long()]
        if "wstack" in ctx:
            x, k_all, v_all = decoder_stack_step(
                x, t, ctx["cross_k"], ctx["cross_v"], ctx["src_mask"],
                state["k_all"], state["v_all"], ctx["wstack"],
                n_heads=self.num_heads)
            new_state = {"t": t + 1, "k_all": k_all, "v_all": v_all}
        else:
            new_state = {"t": t + 1}
            for li in range(self.num_layers):
                x, new_state[f"k{li}"], new_state[f"v{li}"] = (
                    decoder_layer_step(
                        x, t, ctx["cross"][li]["k"], ctx["cross"][li]["v"],
                        ctx["src_mask"], state[f"k{li}"], state[f"v{li}"],
                        ctx["wpack"][li], n_heads=self.num_heads))
        logits = linear(self.generator, layer_norm(self.dec_norm, x))
        return torch.log_softmax(logits, dim=-1), new_state
