"""Training LayerNorm: the wrappers of `csrc/ln_train.cu`.

Replaces the TPU kernels `unpaired_image_captioning_tpu/ops/ln_train.py
::_fwd_kernel` and `::_bwd_kernel` (`fused_layer_norm`). The plain versions
are in `ops/ln_train.py`.

`layer_norm_train` is the differentiable entry point (a
`torch.autograd.Function` whose backward is the backward kernel).
`ln_train_fwd` and `ln_train_bwd` run the plain versions for CPU tensors and
launch the kernels for CUDA tensors; they never route a CUDA tensor to the
plain version. `fwd_launches` and `bwd_launches` count kernel launches,
`bf16_fwd_launches` and `bf16_bwd_launches` those of them with a bf16
operand, and `reg_bf16_fwd_launches` / `reg_bf16_bwd_launches` those of
them on the typed register-row instances. `register_instance` states when
a call takes those; the C entry points report the route they ran, and a
wrapper raises where it differs from the rule.

Types (the compute dtype, ROADMAP A15), as the TPU kernel: x and (scale,
offset) are each f32 or bf16, g comes in x's type; y and dx are in x's
type, d_scale / d_offset summed in f32 and cast to scale's type. The routes
give all f32, and all bf16 on the card's cast route (bf16 copies of the
parameters); the CPU route of JAX's default config gives a bf16 x with f32
parameters, which the kernel takes too. Any other mixture raises, naming
it; a CUDA tensor is never converted to reach another entry.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.ln_train import ln_train_plain, ln_train_plain_bwd
from . import build

fwd_launches = 0
bwd_launches = 0
bf16_fwd_launches = 0
bf16_bwd_launches = 0
reg_bf16_fwd_launches = 0
reg_bf16_bwd_launches = 0

_TYPES = (torch.float32, torch.bfloat16)
# the kernel's type flags (csrc/ln_train.cuh): x, scale / offset, y / dx,
# g, B6 / B7's residual, the rounding of a bf16 computation, d_scale /
# d_offset
LN_X_BF, LN_P_BF, LN_Y_BF, LN_G_BF, LN_R_BF, LN_RND, LN_D_BF = (
    1, 2, 4, 8, 16, 32, 64)
# the widest row the typed register-row instances hold: 4 chunks of 8
# columns a lane
REG_MAX_D = 1024
# the route the C entry points report (csrc/ln_train.cuh LN_ROUTE_*): the
# f32 kernels, the general typed instances, the typed register-row ones
ROUTE_F32, ROUTE_TYPED, ROUTE_ROWS = 0, 1, 2


def mixture(name: str, x, scale, offset, g=None) -> int:
    """The kernel's flags for the operands' types; raises, naming the
    mixture, on one the kernel does not take."""
    if (x.dtype not in _TYPES or scale.dtype not in _TYPES
            or offset.dtype != scale.dtype
            or (g is not None and g.dtype != x.dtype)):
        raise ValueError(
            f"{name}: no kernel entry for the mixture x {x.dtype}, scale "
            f"{scale.dtype}, offset {offset.dtype}"
            + ("" if g is None else f", g {g.dtype}")
            + ": x and (scale, offset) each float32 or bfloat16, offset "
            "with scale and g with x")
    fl = 0
    if x.dtype == torch.bfloat16:
        fl |= LN_X_BF | LN_Y_BF | LN_G_BF | LN_RND
    if scale.dtype == torch.bfloat16:
        fl |= LN_P_BF | LN_D_BF
    return fl


def register_instance(d: int, flags: int, aligned: bool,
                      res: bool = False) -> bool:
    """The routing rule of `csrc/ln_train.cu` (`typed_rows`): whether a
    call of width d with the type flags `flags` (`mixture`'s, or B6 / B7's
    with LN_R_BF for a bf16 residual) runs the typed register-row instances,
    forward or backward. They take a bf16 x with y / dx bf16, and a bf16
    residual where the call has one (`res`); g or the parameters bf16 (the
    routes' mixtures: all bf16, a bf16 x over f32 parameters, B6 / B7's f32
    dy over bf16 parameters); d a multiple of 8 up to REG_MAX_D; every
    pointer on 16 bytes (`aligned`). Every other typed call runs the
    general typed instances, an all-f32 call the f32 kernels."""
    return (bool(flags & LN_X_BF) and bool(flags & LN_Y_BF)
            and bool(flags & (LN_G_BF | LN_P_BF))
            and d % 8 == 0 and 8 <= d <= REG_MAX_D and bool(aligned)
            and (not res or bool(flags & LN_R_BF)))


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _ran(name: str, got: int, d: int, fl: int, tensors) -> bool:
    """The route the C call reported, held against `register_instance`;
    whether it ran the register-row instances."""
    want = (ROUTE_ROWS if register_instance(d, fl, _aligned(*tensors))
            else ROUTE_TYPED if fl else ROUTE_F32)
    if got != want:
        raise RuntimeError(f"{name}: the kernel ran route {got}, the rule "
                           f"names {want} (types {fl}, d {d})")
    return got == ROUTE_ROWS


def _check(name: str, tensors: dict, d: int, device) -> None:
    if d < 2:
        raise ValueError(f"{name}: width {d} outside what the kernel takes "
                         "(at least 2: the variance divides by d - 1)")
    for key, (t, shape) in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {key} must be on {device}, got "
                             f"{t.device}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def ln_train_fwd(x, scale, offset, eps: float = 1e-6):
    """y = LayerNorm(x) over the last axis (see `ops.ln_train`)."""
    global fwd_launches, bf16_fwd_launches, reg_bf16_fwd_launches
    if x.device.type == "cpu":
        return ln_train_plain(x, scale, offset, eps)
    if x.device.type != "cuda":
        raise ValueError(f"ln_train_fwd: unsupported device {x.device}")
    d = x.shape[-1]
    fl = mixture("ln_train_fwd", x, scale, offset)
    _check("ln_train_fwd", {"x": (x, x.shape), "scale": (scale, (d,)),
                            "offset": (offset, (d,))}, d, x.device)
    y = torch.empty_like(x)
    lib = build.load()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ran = ctypes.c_int(-1)
    err = lib.ln_train_fwd_mixed(x.data_ptr(), scale.data_ptr(),
                                 offset.data_ptr(), y.data_ptr(),
                                 x.numel() // d, d, eps, fl,
                                 ctypes.addressof(ran), stream)
    build.check(err, "ln_train_fwd_mixed")
    fwd_launches += 1
    bf16_fwd_launches += fl != 0
    reg_bf16_fwd_launches += _ran("ln_train_fwd", ran.value, d, fl,
                                  (x, scale, offset, y))
    return y


def ln_train_bwd(x, scale, g, eps: float = 1e-6):
    """(dx, d_scale, d_offset); d_scale and d_offset sum over every row."""
    global bwd_launches, bf16_bwd_launches, reg_bf16_bwd_launches
    if x.device.type == "cpu":
        return ln_train_plain_bwd(x, scale, g, eps)
    if x.device.type != "cuda":
        raise ValueError(f"ln_train_bwd: unsupported device {x.device}")
    d = x.shape[-1]
    fl = mixture("ln_train_bwd", x, scale, scale, g)
    _check("ln_train_bwd", {"x": (x, x.shape), "scale": (scale, (d,)),
                            "g": (g, x.shape)}, d, x.device)
    rows = x.numel() // d
    dx = torch.empty_like(x)
    d_scale = torch.empty((d,), dtype=scale.dtype, device=x.device)
    d_offset = torch.empty_like(d_scale)
    lib = build.load()
    n = ctypes.c_longlong()
    build.check(lib.ln_train_bwd_ws_f32(d, ctypes.byref(n)),
                "ln_train_bwd_ws_f32")
    ws = torch.empty((n.value,), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ran = ctypes.c_int(-1)
    err = lib.ln_train_bwd_mixed(x.data_ptr(), scale.data_ptr(),
                                 g.data_ptr(), dx.data_ptr(),
                                 d_scale.data_ptr(), d_offset.data_ptr(),
                                 ws.data_ptr(), rows, d, eps, fl,
                                 ctypes.addressof(ran), stream)
    build.check(err, "ln_train_bwd_mixed")
    bwd_launches += 1
    bf16_bwd_launches += fl != 0
    reg_bf16_bwd_launches += _ran("ln_train_bwd", ran.value, d, fl,
                                  (x, scale, g, dx))
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
    """Differentiable training LayerNorm over the last axis of x (f32 or
    bf16, contiguous on the card); gradients flow to x, scale and offset."""
    return _LayerNormTrain.apply(x, scale, offset, eps)
