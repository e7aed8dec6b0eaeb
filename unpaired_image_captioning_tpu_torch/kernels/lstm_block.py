"""Timestep-blocked LSTM chain: the wrappers of `csrc/lstm_block.cu`.

Replaces the TPU kernels `unpaired_image_captioning_tpu/ops/lstm_block.py
::_chain_fwd_kernel` and `::_chain_bwd_kernel` (routed there by
`blocked_lstm_chain`). The plain versions are in `ops/lstm_block.py`.

`blocked_lstm_chain` is the differentiable entry point: a
`torch.autograd.Function` whose forward is the forward kernel and whose
backward is the backward kernel, which emits dgates (= dx_contrib), dh0 and
dc0; dW_h2h = hs_prev^T @ dgates is one `torch.matmul`, as the JAX package
computes it outside its kernel. `chain_fwd` and `chain_bwd` run the plain
versions for CPU tensors and launch the kernels for CUDA tensors (f32,
contiguous), raising on anything else, including a shape whose grid cannot
be co-resident on the card; they never route a CUDA tensor to the plain
version. Each kernel is one cooperative launch a chain: `fwd_launches` and
`bwd_launches` count them, `fwd_bf16_launches` and `bwd_bf16_launches`
those with a bf16 operand, `tc_fwd_launches` and `tc_bwd_launches` those
that ran the tensor-core instance. The backward's workspace (the FMA
core's partial dh sums or the tensor-core instance's bf16 dgates, sized by
the CUDA source) is allocated here.

Types (ROADMAP A15): x_contrib and the gates f32; the carry (h0, c0 and
their cotangents) of one type and w_h2h, each f32 or bf16 (the cast points
are `ops/lstm_block.py`'s). Any other mixture raises, naming it; a CUDA
tensor is never converted to reach another entry. dW = hs_prev^T @ dgates
is taken in f32 and returned in w_h2h's type, as JAX's is.

`tensor_core(types, backward)` is the routing rule, JAX's cast points: the
forward's `jnp.dot(h_scr, w)` multiplies two bf16 operands exactly when the
carry and w_h2h are bf16 (an f32 operand promotes the product to f32), and
the backward's `jnp.dot(dgates.astype(wT.dtype), wT)` whenever w_h2h is
bf16, whatever the carry's type. Those calls run the tensor-core instances
(bf16 products with f32 sums, `mma.sync`); the rest the f32 FMA core, which
converts each bf16 operand as it loads it. The C entries report the route
they ran and the wrappers raise where it differs from the rule. A shape
either instance cannot take raises, naming the instance; nothing falls
back to the other.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.lstm_block import chain_bwd_plain, chain_fwd_plain
from . import build

fwd_launches = 0
bwd_launches = 0
fwd_bf16_launches = 0
bwd_bf16_launches = 0
tc_fwd_launches = 0
tc_bwd_launches = 0

_TYPES = (torch.float32, torch.bfloat16)

_TOO_LARGE = 720   # cudaErrorCooperativeLaunchTooLarge


def _mixture(name: str, f32: dict, carry: dict, w) -> int:
    """The kernel's `types` bits (0: the carry bf16, 1: w_h2h bf16); raises,
    naming the mixture, where `f32` holds anything but f32, the carry
    tensors differ in type, or a type is neither f32 nor bf16."""
    kinds = {t.dtype for t in carry.values()}
    if (any(t.dtype != torch.float32 for t in f32.values())
            or len(kinds) != 1 or not kinds <= set(_TYPES)
            or w.dtype not in _TYPES):
        mix = ", ".join(f"{k} {t.dtype}" for k, t in
                        list(f32.items()) + list(carry.items())
                        + [("w_h2h", w)])
        raise ValueError(
            f"{name}: no kernel entry for the mixture {mix}: "
            f"{', '.join(f32)} float32, the carry ({', '.join(carry)}) of "
            "one type and w_h2h each float32 or bfloat16")
    return (int(kinds == {torch.bfloat16})
            | int(w.dtype == torch.bfloat16) << 1)


def tensor_core(types: int, backward: bool) -> bool:
    """The routing rule: whether a mixture (`_mixture`'s bits: 1 the carry,
    2 w_h2h bf16) runs the tensor-core instance in that direction."""
    return bool(types & 2) if backward else types == 3


def _check(name: str, tensors: dict, device) -> None:
    for key, (t, shape) in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {key} must be on {device}, got "
                             f"{t.device}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def _gates(gh: int, hidden: int, maxout: bool) -> int:
    g = 5 if maxout else 4
    if gh != g * hidden:
        raise ValueError(f"lstm chain: {gh} gate columns for H = {hidden}, "
                         f"expected {g} * H (maxout={maxout})")
    return g


def _raise_on(err: int, name: str, shape, tc: bool, route: int) -> None:
    instance = "tensor-core instance" if tc else "f32 FMA core"
    if err == _TOO_LARGE:
        raise RuntimeError(f"{name} ({instance}): the grid for {shape} "
                           f"cannot be co-resident on this card (cooperative "
                           f"launch refused)")
    build.check(err, name)
    if route != tc:
        raise RuntimeError(f"{name}: ran the route {route}, the rule gives "
                           f"the {instance}")


def chain_fwd(x_contrib, h0, c0, w_h2h, *, maxout: bool):
    """(hs, cs [T, B, H] in the carry's type, gates [T, B, G*H] f32)."""
    global fwd_launches, fwd_bf16_launches, tc_fwd_launches
    if x_contrib.device.type == "cpu":
        return chain_fwd_plain(x_contrib, h0, c0, w_h2h, maxout=maxout)
    if x_contrib.device.type != "cuda":
        raise ValueError(f"chain_fwd: unsupported device {x_contrib.device}")
    t, b, gh = x_contrib.shape
    hidden = h0.shape[-1]
    g = _gates(gh, hidden, maxout)
    _check("chain_fwd", {"x_contrib": (x_contrib, (t, b, gh)),
                         "h0": (h0, (b, hidden)), "c0": (c0, (b, hidden)),
                         "w_h2h": (w_h2h, (hidden, gh))}, x_contrib.device)
    types = _mixture("chain_fwd", {"x_contrib": x_contrib},
                     {"h0": h0, "c0": c0}, w_h2h)
    hs = torch.empty((t, b, hidden), dtype=h0.dtype, device=x_contrib.device)
    cs = torch.empty_like(hs)
    gates = torch.empty_like(x_contrib)
    lib = build.load()
    stream = torch.cuda.current_stream(x_contrib.device).cuda_stream
    route = ctypes.c_int(-1)
    err = lib.lstm_chain_fwd_mixed(
        x_contrib.data_ptr(), h0.data_ptr(), c0.data_ptr(), w_h2h.data_ptr(),
        hs.data_ptr(), cs.data_ptr(), gates.data_ptr(), t, b, hidden, g,
        types, ctypes.byref(route), stream)
    tc = tensor_core(types, False)
    _raise_on(err, "lstm_chain_fwd_mixed", (t, b, gh), tc, route.value)
    fwd_launches += 1
    fwd_bf16_launches += types != 0
    tc_fwd_launches += tc
    return hs, cs, gates


def chain_bwd(gates, cs, c0, dhs, dcs, w_h2h, *, maxout: bool):
    """(dgates [T, B, G*H] f32, dh0, dc0 [B, H] in the carry's type)."""
    global bwd_launches, bwd_bf16_launches, tc_bwd_launches
    if gates.device.type == "cpu":
        return chain_bwd_plain(gates, cs, c0, dhs, dcs, w_h2h, maxout=maxout)
    if gates.device.type != "cuda":
        raise ValueError(f"chain_bwd: unsupported device {gates.device}")
    t, b, gh = gates.shape
    hidden = c0.shape[-1]
    g = _gates(gh, hidden, maxout)
    seq = (t, b, hidden)
    _check("chain_bwd", {"gates": (gates, (t, b, gh)), "cs": (cs, seq),
                         "c0": (c0, (b, hidden)), "dhs": (dhs, seq),
                         "dcs": (dcs, seq), "w_h2h": (w_h2h, (hidden, gh))},
           gates.device)
    types = _mixture("chain_bwd", {"gates": gates},
                     {"cs": cs, "c0": c0, "dhs": dhs, "dcs": dcs}, w_h2h)
    dgates = torch.empty_like(gates)
    dh0 = torch.empty_like(c0)
    dc0 = torch.empty_like(c0)
    lib = build.load()
    n = ctypes.c_int64()
    lib.lstm_chain_bwd_ws_f32(b, hidden, ctypes.byref(n))
    ws = torch.empty((max(n.value, 1),), dtype=torch.float32,
                     device=gates.device)
    stream = torch.cuda.current_stream(gates.device).cuda_stream
    route = ctypes.c_int(-1)
    err = lib.lstm_chain_bwd_mixed(
        gates.data_ptr(), cs.data_ptr(), c0.data_ptr(), dhs.data_ptr(),
        dcs.data_ptr(), w_h2h.data_ptr(), dgates.data_ptr(), dh0.data_ptr(),
        dc0.data_ptr(), ws.data_ptr(), t, b, hidden, g, types,
        ctypes.byref(route), stream)
    tc = tensor_core(types, True)
    _raise_on(err, "lstm_chain_bwd_mixed", (t, b, gh), tc, route.value)
    bwd_launches += 1
    bwd_bf16_launches += types != 0
    tc_bwd_launches += tc
    return dgates, dh0, dc0


class _Chain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_contrib, h0, c0, w_h2h, maxout):
        hs, cs, gates = chain_fwd(x_contrib, h0, c0, w_h2h, maxout=maxout)
        ctx.save_for_backward(hs, cs, gates, h0, c0, w_h2h)
        ctx.maxout = maxout
        return hs, cs

    @staticmethod
    def backward(ctx, dhs, dcs):
        hs, cs, gates, h0, c0, w_h2h = ctx.saved_tensors
        dhs = torch.zeros_like(hs) if dhs is None else dhs.contiguous()
        dcs = torch.zeros_like(cs) if dcs is None else dcs.contiguous()
        dgates, dh0, dc0 = chain_bwd(gates, cs, c0, dhs, dcs, w_h2h,
                                     maxout=ctx.maxout)
        dw = None
        if ctx.needs_input_grad[3]:
            hs_prev = torch.cat([h0[None], hs[:-1]], dim=0).float()
            dw = torch.matmul(hs_prev.reshape(-1, hs.shape[-1]).t(),
                              dgates.reshape(-1, gates.shape[-1])
                              ).to(w_h2h.dtype)
        return dgates, dh0, dc0, dw, None


def blocked_lstm_chain(x_contrib, h0, c0, w_h2h, *, maxout: bool = True):
    """T LSTM steps over hoisted input contributions (time-major).

    x_contrib: [T, B, G*H], the precomputed `x @ w_i2h + b`;
    h0, c0:    [B, H];
    w_h2h:     [H, G*H], the hidden rows of the cell's fused weight.
    Returns (hs [T, B, H], cs [T, B, H]), differentiable in all four inputs
    (both the h and the c cotangents are honoured).
    """
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x_contrib, h0, c0, w_h2h)):
        return _Chain.apply(x_contrib, h0, c0, w_h2h, maxout)
    hs, cs, _ = chain_fwd(x_contrib, h0, c0, w_h2h, maxout=maxout)
    return hs, cs
