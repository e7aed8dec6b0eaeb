"""Training LayerNorm: the wrappers of `csrc/ln_train.cu`.

Replaces the TPU kernels `unpaired_image_captioning_tpu/ops/ln_train.py
::_fwd_kernel` and `::_bwd_kernel` (`fused_layer_norm`). The plain versions
are in `ops/ln_train.py`.

`layer_norm_train` is the differentiable entry point (a
`torch.autograd.Function` whose backward is the backward kernel).
`ln_train_fwd` and `ln_train_bwd` run the plain versions for CPU tensors and
launch the kernels for CUDA tensors; they never route a CUDA tensor to the
plain version. `fwd_launches` and `bwd_launches` count kernel launches.
"""

from __future__ import annotations

import torch

from ..ops.ln_train import ln_train_plain, ln_train_plain_bwd
from . import build

fwd_launches = 0
bwd_launches = 0

MAX_SMEM = 227 * 1024   # bytes of shared memory a Hopper block can opt into
BWD_WARPS = 8           # WARPS of the CUDA source
MAX_BWD_BLOCKS = 264    # two blocks per SM of the H100's 132


def _check(name: str, tensors: dict, d: int, device) -> None:
    if d < 2 or BWD_WARPS * 2 * d * 4 > MAX_SMEM:
        raise ValueError(f"{name}: width {d} outside what the kernel takes "
                         f"(2 to {MAX_SMEM // (BWD_WARPS * 8)})")
    for key, (t, shape) in tensors.items():
        if t.device != device or t.dtype != torch.float32:
            raise ValueError(f"{name}: {key} must be f32 on {device}, got "
                             f"{t.dtype} on {t.device}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def ln_train_fwd(x, scale, offset, eps: float = 1e-6):
    """y = LayerNorm(x) over the last axis (see `ops.ln_train`)."""
    global fwd_launches
    if x.device.type == "cpu":
        return ln_train_plain(x, scale, offset, eps)
    if x.device.type != "cuda":
        raise ValueError(f"ln_train_fwd: unsupported device {x.device}")
    d = x.shape[-1]
    _check("ln_train_fwd", {"x": (x, x.shape), "scale": (scale, (d,)),
                            "offset": (offset, (d,))}, d, x.device)
    y = torch.empty_like(x)
    lib = build.load()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.ln_train_fwd_f32(x.data_ptr(), scale.data_ptr(),
                               offset.data_ptr(), y.data_ptr(),
                               x.numel() // d, d, eps, stream)
    build.check(err, "ln_train_fwd_f32")
    fwd_launches += 1
    return y


def ln_train_bwd(x, scale, g, eps: float = 1e-6):
    """(dx, d_scale, d_offset); d_scale and d_offset sum over every row."""
    global bwd_launches
    if x.device.type == "cpu":
        return ln_train_plain_bwd(x, scale, g, eps)
    if x.device.type != "cuda":
        raise ValueError(f"ln_train_bwd: unsupported device {x.device}")
    d = x.shape[-1]
    _check("ln_train_bwd", {"x": (x, x.shape), "scale": (scale, (d,)),
                            "g": (g, x.shape)}, d, x.device)
    rows = x.numel() // d
    nblk = max(1, min(MAX_BWD_BLOCKS, -(-rows // BWD_WARPS)))
    dx = torch.empty_like(x)
    d_scale = torch.empty((d,), dtype=torch.float32, device=x.device)
    d_offset = torch.empty_like(d_scale)
    partial = torch.empty((nblk, 2, d), dtype=torch.float32, device=x.device)
    lib = build.load()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.ln_train_bwd_f32(x.data_ptr(), scale.data_ptr(), g.data_ptr(),
                               dx.data_ptr(), d_scale.data_ptr(),
                               d_offset.data_ptr(), partial.data_ptr(), rows,
                               d, nblk, eps, stream)
    build.check(err, "ln_train_bwd_f32")
    bwd_launches += 1
    return dx, d_scale, d_offset


class _LayerNormTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, offset, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return ln_train_fwd(x, scale, offset, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx, d_scale, d_offset = ln_train_bwd(x, scale, g.contiguous(),
                                             ctx.eps)
        return dx, d_scale, d_offset, None


def layer_norm_train(x, scale, offset, eps: float = 1e-6):
    """Differentiable training LayerNorm over the last axis of x (f32,
    contiguous on the card); gradients flow to x, scale and offset."""
    return _LayerNormTrain.apply(x, scale, offset, eps)
