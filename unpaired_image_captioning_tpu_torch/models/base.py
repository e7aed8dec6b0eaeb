"""Caption decoder base (counterpart of
`unpaired_image_captioning_tpu/models/base.py`).

The JAX package describes each model as a frozen dataclass of pure
functions over a parameter pytree. Here each model is an `nn.Module` that
owns its parameters, with the same parameter names (`state_dict()` keys
read like the JAX tree's paths) and the same decode interface minus the
`params` argument:

    init_params(generator)              -> self, parameters drawn in place
    make_decoder(feats)                 -> (ctx, state0)
    step(ctx, state, it)                -> (logprobs [B, V+1], state)
    forward(feats, seq)                 -> logprobs [B, T-1, V+1]
    sample(feats)                       -> (seq [B, T], logprobs [B, T])
    sample_beam(feats, beam_size=...)   -> BeamResult

`ctx` holds per-sequence tensors that are constant across decode steps and
identical across beams; `state` is the recurrent carry that beam search
reorders.
"""

from __future__ import annotations

import inspect
import math
from typing import NamedTuple, Optional

import torch
from torch import nn

from ..ops.rnn import uniform
from ..ops.sampling import gumbel_argmax, sample as sample_tokens


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point builds on: the card unless the caller names
    another. Raises when the card is asked for and there is none, so that
    nothing is quietly built on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to build on the "
                           "CPU")
    return dev


class Features(NamedTuple):
    """One batch of precomputed image features.

    fc_feats:    [B, fc_feat_size]
    att_feats:   [B, N, att_feat_size] or None
    attri_feats: [B, attri_feat_size] or None (stackcap attributes)
    att_masks:   [B, N] 0/1 or None
    """

    fc_feats: torch.Tensor
    att_feats: Optional[torch.Tensor] = None
    attri_feats: Optional[torch.Tensor] = None
    att_masks: Optional[torch.Tensor] = None


class Linear(nn.Module):
    """`x @ w + b` with the JAX layout: w [in, out], b [out] (or no b)."""

    def __init__(self, in_dim: int, out_dim: int, *, bias: bool = True,
                 scale: Optional[float] = None, device=None):
        super().__init__()
        self.in_dim, self.out_dim = in_dim, out_dim
        self.scale = scale
        self.w = nn.Parameter(torch.empty((in_dim, out_dim), device=device))
        self.b = (nn.Parameter(torch.empty((out_dim,), device=device))
                  if bias else None)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """w ~ uniform(-s, s) with s = `scale`, by default 1/sqrt(in), and
        b = 0, as linear_init."""
        scale = (self.scale if self.scale is not None
                 else 1.0 / math.sqrt(self.in_dim))
        self.w.copy_(uniform(self.w.shape, scale, generator))
        if self.b is not None:
            self.b.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(self, x)


def linear_init(in_dim: int, out_dim: int, *, bias: bool = True,
                scale: Optional[float] = None, device=None) -> Linear:
    return Linear(in_dim, out_dim, bias=bias, scale=scale, device=device)


def mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w as `jnp.dot(x, w, preferred_element_type=f32)` computes it:
    operands of one type multiply in that type (bf16 products accumulate in
    f32); of two types they are promoted to f32 first, where torch.matmul
    would refuse the mixture."""
    if x.dtype == w.dtype:
        return x @ w
    return x.float() @ w.float()


def dot_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """`jnp.dot(x, w, preferred_element_type=f32)` left in f32: f32 products
    of the operands' values (exact for bf16), summed in f32."""
    return x.float() @ w.float()


def weak(c: float, x: torch.Tensor):
    """The Python scalar c as JAX applies it to x (a weakly typed scalar):
    in x's type, so against a bf16 x it is c rounded to bf16 (torch would
    compute with c in f32). A 0-d CPU tensor, which torch applies to a
    tensor on any device."""
    return torch.tensor(c, dtype=x.dtype) if x.dtype == torch.bfloat16 else c


def linear(p: Linear, x: torch.Tensor) -> torch.Tensor:
    """The JAX package's `linear`: the product in x's type, then the bias in
    x's type (bf16 features through f32 weights come out bf16)."""
    y = mm(x, p.w).to(x.dtype)
    return y if p.b is None else y + p.b.to(x.dtype)


def embedding_init(vocab: int, dim: int, *, device=None) -> nn.Parameter:
    """Uninitialised [vocab, dim] table; `init_embedding` fills it."""
    return nn.Parameter(torch.empty((vocab, dim), device=device))


@torch.no_grad()
def init_embedding(table: torch.Tensor, generator: torch.Generator,
                   scale: float = 0.1) -> None:
    """uniform(-0.1, 0.1), as the JAX embedding_init."""
    table.copy_(uniform(table.shape, scale, generator))


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout; identity at inference or without a generator."""
    if not training or rate <= 0.0 or generator is None:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1 - rate
    return torch.where(keep, x / weak(1.0 - rate, x), torch.zeros_like(x))


def init_module(module: nn.Module, generator: torch.Generator) -> None:
    """Draw every parameter below `module`: each child that defines
    `init_params(generator)` initializes its own subtree, other children
    (ModuleList, ModuleDict) are walked in registration order."""
    for child in module.children():
        if hasattr(child, "init_params"):
            child.init_params(generator)
        else:
            init_module(child, generator)


class CaptionDecoder(nn.Module):
    """Base class of the caption families."""

    def __init__(self, *, vocab_size: int, input_encoding_size: int,
                 rnn_size: int, num_layers: int, drop_prob_lm: float,
                 seq_length: int, fc_feat_size: int):
        super().__init__()
        self.vocab_size = vocab_size
        self.input_encoding_size = input_encoding_size
        self.rnn_size = rnn_size
        self.num_layers = num_layers
        self.drop_prob_lm = drop_prob_lm
        self.seq_length = seq_length
        self.fc_feat_size = fc_feat_size

    @classmethod
    def from_config(cls, cfg, *, device="cuda") -> "CaptionDecoder":
        """Build from a config object, reading the constructor's keyword
        arguments from the attributes of the same names, on the card unless
        `device` names another."""
        kwargs = {}
        for name, prm in inspect.signature(cls.__init__).parameters.items():
            if name in ("self", "device") or prm.kind != prm.KEYWORD_ONLY:
                continue
            if hasattr(cfg, name):
                kwargs[name] = getattr(cfg, name)
            elif prm.default is inspect.Parameter.empty:
                raise ValueError(f"config missing required field {name!r}")
        return cls(**kwargs, device=resolve_device(device))

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    # ---- to implement -----------------------------------------------------
    def init_params(self, generator: torch.Generator) -> "CaptionDecoder":
        raise NotImplementedError

    def make_decoder(self, feats: Features, *, training: bool = False,
                     generator: Optional[torch.Generator] = None):
        raise NotImplementedError

    def step(self, ctx, state, it, *, training: bool = False,
             generator: Optional[torch.Generator] = None):
        """One decode step: (logprobs [B, V+1], new state), the head over
        `step_core`'s hidden."""
        h, state = self.step_core(ctx, state, it, training=training,
                                  generator=generator)
        return self.head(h, training=training, generator=generator), state

    def step_core(self, ctx, state, it, *, training: bool = False,
                  generator: Optional[torch.Generator] = None):
        """Returns (h [B, H] pre-head hidden, new state)."""
        raise NotImplementedError

    def head(self, h, *, training: bool = False,
             generator: Optional[torch.Generator] = None):
        """Pointwise-in-time completion: h [..., H] -> logprobs [..., V+1]."""
        raise NotImplementedError

    def decode_ctx(self, ctx):
        """Hook for one-time ctx transforms before a decode loop (sample,
        sample_beam only); the attention family's widens a bf16 memory
        (`models/att.py`). The identity here."""
        return ctx

    @property
    def beam_ctx_no_expand(self) -> tuple:
        """ctx keys beam search leaves unexpanded ([B, ...] shared across
        beams); the model's attention broadcasts them over beams."""
        return ()

    # ---- shared ------------------------------------------------------------
    def forward(self, feats: Features, seq: torch.Tensor, *,
                training: bool = False,
                generator: Optional[torch.Generator] = None,
                ss_prob: float = 0.0,
                ss_enabled: Optional[bool] = None,
                aux_out: Optional[dict] = None) -> torch.Tensor:
        """Teacher-forcing forward.

        seq: [B, L] caption labels incl. the leading BOS(0) column. Returns
        logprobs [B, L-1, V+1] where slot j predicts seq[:, j+1].

        Scheduled sampling (training with `ss_enabled`, which defaults to
        ss_prob > 0): at each step t > 0, per element, with probability
        ss_prob the input token is replaced by a draw from the previous
        step's output distribution; the coin and the draw come from
        `generator`, and no coin is thrown at t = 0 (the BOS input stays).
        This is the JAX package's non-hoisted body; without it the head is
        hoisted out of the time loop (the split-head path).

        aux_out: a dict the forward fills with detached side statistics
        (the `use_bn` batch moments, for `att.apply_bn_updates`); passed to
        `make_decoder` only when given.
        """
        if ss_enabled is None:
            ss_enabled = ss_prob > 0
        use_ss = training and ss_enabled
        if use_ss and generator is None:
            raise ValueError("scheduled sampling draws from a generator")
        mk = {} if aux_out is None else {"aux_out": aux_out}
        ctx, state = self.make_decoder(feats, training=training,
                                       generator=generator, **mk)
        if not use_ss:
            hs = []
            for t in range(seq.shape[1] - 1):
                h, state = self.step_core(ctx, state, seq[:, t],
                                          training=training,
                                          generator=generator)
                hs.append(h)
            out = self.head(torch.stack(hs), training=training,
                            generator=generator)              # [T, B, V+1]
            return out.transpose(0, 1)

        batch = seq.shape[0]
        outs = []
        prev = None
        for t in range(seq.shape[1] - 1):
            it = seq[:, t]
            if t > 0:
                coin = torch.rand((batch,), generator=generator,
                                  device=seq.device) < ss_prob
                sampled = gumbel_argmax(prev, generator).to(it.dtype)
                it = torch.where(coin, sampled, it)
            logprobs, state = self.step(ctx, state, it, training=training,
                                        generator=generator)
            prev = logprobs.detach()
            outs.append(logprobs)
        return torch.stack(outs, 1)

    @torch.no_grad()
    def sample(self, feats: Features, *, greedy: bool = True,
               temperature: float = 1.0, seq_length: Optional[int] = None,
               generator: Optional[torch.Generator] = None):
        """Batched greedy or multinomial decode (reference
        AttModel._sample); multinomial draws from `generator`. Runs without
        gradients: the tokens are discrete, and the decode-only kernels
        (STEP_FUSION) have no backward. Returns (seq [B, T] int64,
        logprobs [B, T] f32)."""
        ctx, state0 = self.make_decoder(feats, training=False)
        ctx = self.decode_ctx(ctx)

        def step_fn(state, it):
            return self.step(ctx, state, it, training=False)

        return sample_tokens(step_fn, state0, feats.fc_feats.shape[0],
                       seq_length or self.seq_length,
                       device=feats.fc_feats.device, greedy=greedy,
                       temperature=temperature, generator=generator)

    def sample_beam(self, feats: Features, *, beam_size: int, **beam_opts):
        """Batched beam search over [batch, beam] (caption beam semantics:
        UNK suppression, EOS dead slots; see ops/beam_search.py)."""
        from ..ops.beam_search import beam_search

        ctx, state0 = self.make_decoder(feats, training=False)
        ctx = self.decode_ctx(ctx)

        def step_fn(c, state, it):
            return self.step(c, state, it, training=False)

        return beam_search(step_fn, ctx, state0, beam_size=beam_size,
                           seq_length=self.seq_length,
                           ctx_no_expand=self.beam_ctx_no_expand, **beam_opts)
