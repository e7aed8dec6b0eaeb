"""Training LayerNorm, plain PyTorch (counterpart of
`unpaired_image_captioning_tpu/ops/ln_train.py`).

The function of the Pallas `fused_layer_norm` and of its CUDA port
(`kernels/ln_train.py`, `csrc/ln_train.cu`): over the last axis, in f32,
the reference LayerNorm with the unbiased (n - 1) variance and eps outside
the sqrt; `ln_train_plain_bwd` is the Pallas `_bwd_kernel` written out,
with d_scale and d_offset summed over every row.
"""

from __future__ import annotations

import torch


def _stats(x: torch.Tensor, eps: float):
    n = x.shape[-1]
    mean = x.mean(-1, keepdim=True)
    var = torch.square(x - mean).sum(-1, keepdim=True) / (n - 1)
    return mean, var, torch.sqrt(var) + eps


def ln_train_plain(x, scale, offset, eps: float = 1e-6):
    """y = (x - mean) / (sqrt(var) + eps) * scale + offset."""
    mean, _, s = _stats(x, eps)
    return (x - mean) / s * scale + offset


def ln_train_plain_bwd(x, scale, g, eps: float = 1e-6):
    """(dx, d_scale, d_offset) for the upstream gradient g."""
    n = x.shape[-1]
    mean, var, s = _stats(x, eps)
    xm = x - mean
    dxhat = g * scale
    dvar = ((dxhat * xm).sum(-1, keepdim=True) * (-1.0 / (s * s))
            * (0.5 / torch.sqrt(var)))
    dmean = -dxhat.sum(-1, keepdim=True) / s
    dx = dxhat / s + dvar * (2.0 / (n - 1)) * xm + dmean / n
    gr = g.reshape(-1, n)
    d_scale = (gr * (xm.reshape(-1, n) / s.reshape(-1, 1))).sum(0)
    return dx, d_scale, gr.sum(0)
