"""Dual optimizer with the reference's schedules (counterpart of
`unpaired_image_captioning_tpu/train/optimizer.py`).

Each method is a gradient transform written as plain tensor code over a
dict of named tensors, computing what the JAX package's optax chain
computes: global-norm clip, then the method, then weight decay. The
learning rate is not part of the transform: it is a host scalar from the
schedules below, and the caller applies `p -= lr * u`. The state of each
part of the chain is a dict whose keys are optax's field names (`count`,
`mu`, `nu`, `trace`, `sum_of_squares`), so `bridge.py` maps it to and from
an optax state.

Two traps of `torch.optim`, which this module does not use:
- `torch.nn.utils.clip_grad_norm_` scales by max_norm / (norm + 1e-6) and
  always; `optax.clip_by_global_norm` leaves the gradient alone below the
  bound and scales by max_norm / norm above it.
- `torch.optim.RMSprop` divides by sqrt(nu) + eps and `Adagrad` starts its
  sum at 0 with eps outside the sqrt; optax's `scale_by_rms` multiplies by
  rsqrt(nu + eps) and `scale_by_rss` starts at 0.1 with rsqrt(sum + eps).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

Params = Dict[str, torch.Tensor]


class Transform(NamedTuple):
    """init(params) -> state; update(grads, state, params) -> (updates,
    state). Like an optax GradientTransformation, without the lr scale."""

    init: Callable[[Params], list]
    update: Callable[[Params, list, Params], Tuple[Params, list]]


def _zeros(params: Params, value: float = 0.0) -> Params:
    return {k: torch.full_like(p, value) for k, p in params.items()}


def _bias_correction(decay: float, count: int) -> float:
    """1 - decay^count in f32, as optax's jitted update computes it: the f32
    power rounded once (at b2 = 0.999 a float64 1 - b2^count differs from
    it by up to ~3e-5 relative, which Adam's sqrt halves)."""
    power = np.float32(float(np.float32(decay)) ** count)
    return float(np.float32(1.0) - power)


def _clip_by_global_norm(max_norm: float):
    def init(params):
        return {}

    def update(g, state, params):
        keys = list(g)
        norm = torch.sqrt(torch.stack([torch.sum(g[k] * g[k])
                                       for k in keys]).sum())
        below = norm < max_norm
        return {k: torch.where(below, g[k], g[k] / norm * max_norm)
                for k in keys}, state

    return init, update


def _adam(b1: float, b2: float, eps: float):
    def init(params):
        return {"count": 0, "mu": _zeros(params), "nu": _zeros(params)}

    def update(g, state, params):
        keys = list(g)
        gs = [g[k] for k in keys]
        mu = [state["mu"][k] for k in keys]
        nu = [state["nu"][k] for k in keys]
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, gs, alpha=1.0 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, gs, gs, value=1.0 - b2)
        count = state["count"] + 1
        mu_hat = torch._foreach_div(mu, _bias_correction(b1, count))
        den = torch._foreach_sqrt(torch._foreach_div(
            nu, _bias_correction(b2, count)))
        torch._foreach_add_(den, eps)
        upd = torch._foreach_div(mu_hat, den)
        return (dict(zip(keys, upd)),
                {"count": count, "mu": dict(zip(keys, mu)),
                 "nu": dict(zip(keys, nu))})

    return init, update


def _rms(decay: float, eps: float):
    def init(params):
        return {"nu": _zeros(params)}

    def update(g, state, params):
        keys = list(g)
        gs = [g[k] for k in keys]
        nu = [state["nu"][k] for k in keys]
        torch._foreach_mul_(nu, decay)
        torch._foreach_addcmul_(nu, gs, gs, value=1.0 - decay)
        scale = torch._foreach_rsqrt(torch._foreach_add(nu, eps))
        return (dict(zip(keys, torch._foreach_mul(scale, gs))),
                {"nu": dict(zip(keys, nu))})

    return init, update


def _rss(initial: float, eps: float):
    def init(params):
        return {"sum_of_squares": _zeros(params, initial)}

    def update(g, state, params):
        upd, sos = {}, {}
        for k, gk in g.items():
            t = gk * gk + state["sum_of_squares"][k]
            inv = torch.where(t > 0, torch.rsqrt(t + eps), 0.0)
            upd[k], sos[k] = inv * gk, t
        return upd, {"sum_of_squares": sos}

    return init, update


def _trace(decay: float, nesterov: bool):
    def init(params):
        return {"trace": _zeros(params)}

    def update(g, state, params):
        new = {k: g[k] + decay * state["trace"][k] for k in g}
        upd = ({k: g[k] + decay * new[k] for k in g} if nesterov else new)
        return upd, {"trace": new}

    return init, update


def _identity():
    return (lambda params: {}), (lambda g, state, params: (g, state))


def _decayed_weights(weight_decay: float):
    def update(g, state, params):
        return {k: g[k] + weight_decay * params[k] for k in g}, state

    return (lambda params: {}), update


def make_transform(method: str, *, alpha: float = 0.9, beta: float = 0.999,
                   eps: float = 1e-8, momentum: float = 0.9,
                   max_grad_norm: float = 0.0,
                   weight_decay: float = 0.0) -> Transform:
    """Gradient transform WITHOUT the lr scale (applied separately)."""
    if method == "adam":
        core = _adam(alpha, beta, eps)
    elif method == "rmsprop":
        core = _rms(alpha, eps)
    elif method == "adagrad":
        core = _rss(0.1, eps)
    elif method == "sgd":
        core = _identity()
    elif method == "sgdm":
        core = _trace(momentum, False)
    elif method == "sgdmom":
        core = _trace(momentum, True)
    else:
        raise ValueError(f"unknown optim method {method!r}")
    parts = []
    if max_grad_norm and max_grad_norm > 0:
        parts.append(_clip_by_global_norm(max_grad_norm))
    parts.append(core)
    if weight_decay and weight_decay > 0:
        parts.append(_decayed_weights(weight_decay))

    def init(params: Params) -> list:
        return [p_init(params) for p_init, _ in parts]

    def update(grads: Params, state: list, params: Params):
        new_state: List[dict] = []
        for (_, p_update), s in zip(parts, state):
            grads, s = p_update(grads, s, params)
            new_state.append(s)
        return grads, new_state

    return Transform(init, update)


def epoch_decayed_lr(base_lr: float, epoch: int, decay_start: int,
                     decay_every: int, decay_rate: float) -> float:
    """Parity: misc/optimizer.py:114-131 / train.py LR schedule."""
    if decay_start < 0 or epoch < decay_start:
        return base_lr
    frac = (epoch - decay_start) // decay_every
    return base_lr * (decay_rate ** frac)


def noam_lr(model_size: int, factor: float, warmup: int, step: int) -> float:
    """Parity: misc/utils.py NoamOpt :335-364."""
    step = max(step, 1)
    return factor * (model_size ** -0.5
                     * min(step ** -0.5, step * warmup ** -1.5))


def scheduled_sampling_prob(epoch: int, start: int, increase_every: int,
                            increase_prob: float, max_prob: float) -> float:
    """Parity: misc/optimizer.py:108-112."""
    if start < 0 or epoch < start:
        return 0.0
    frac = (epoch - start) // increase_every
    return min(increase_prob * frac, max_prob)


@dataclasses.dataclass
class PlateauScheduler:
    """ReduceLROnPlateau parity (misc/utils.py:367-410): decay when the
    tracked metric stops improving."""

    factor: float = 0.5
    patience: int = 3
    mode: str = "max"
    best: Optional[float] = None
    bad_epochs: int = 0
    scale: float = 1.0

    def update(self, metric: float) -> float:
        better = (self.best is None
                  or (metric > self.best if self.mode == "max"
                      else metric < self.best))
        if better:
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.scale *= self.factor
                self.bad_epochs = 0
        return self.scale


class DualOptim:
    """Holds the i2t and NMT transforms, their states and the host-side
    schedule state (parity: misc/optimizer.py Optim). Parameters are dicts
    of named tensors (`dict(model.named_parameters())`)."""

    def __init__(self, cfg, i2t_params: Optional[Params] = None,
                 nmt_params: Optional[Params] = None):
        self.cfg = cfg
        self.i2t_tx = make_transform(
            cfg.i2t_optim, alpha=cfg.i2t_optim_alpha, beta=cfg.i2t_optim_beta,
            eps=cfg.i2t_optim_epsilon, momentum=cfg.i2t_momentum,
            max_grad_norm=cfg.i2t_max_grad_norm,
            weight_decay=cfg.i2t_weight_decay)
        self.nmt_tx = make_transform(
            cfg.nmt_optim, alpha=cfg.nmt_optim_alpha, beta=cfg.nmt_optim_beta,
            eps=cfg.nmt_optim_epsilon, momentum=cfg.nmt_momentum,
            max_grad_norm=cfg.nmt_max_grad_norm,
            weight_decay=cfg.nmt_weight_decay)
        self.i2t_state = (self.i2t_tx.init(i2t_params)
                          if i2t_params is not None else None)
        self.nmt_state = (self.nmt_tx.init(nmt_params)
                          if nmt_params is not None else None)
        self.i2t_base_lr = cfg.i2t_learning_rate
        self.nmt_base_lr = cfg.nmt_learning_rate
        self.nmt_step = 0

    def i2t_lr(self, epoch: int) -> float:
        return epoch_decayed_lr(self.i2t_base_lr, epoch,
                                self.cfg.i2t_learning_rate_decay_start,
                                self.cfg.i2t_learning_rate_decay_every,
                                self.cfg.i2t_learning_rate_decay_rate)

    def nmt_lr(self, epoch: int) -> float:
        if self.cfg.nmt_decay_method == "noam":
            return noam_lr(self.cfg.rnn_size, self.nmt_base_lr,
                           self.cfg.nmt_warmup_steps, self.nmt_step)
        return epoch_decayed_lr(self.nmt_base_lr, epoch,
                                self.cfg.nmt_learning_rate_decay_start,
                                self.cfg.nmt_learning_rate_decay_every,
                                self.cfg.nmt_learning_rate_decay_rate)

    def ss_prob(self, epoch: int) -> float:
        return scheduled_sampling_prob(
            epoch, self.cfg.scheduled_sampling_start,
            self.cfg.scheduled_sampling_increase_every,
            self.cfg.scheduled_sampling_increase_prob,
            self.cfg.scheduled_sampling_max_prob)
