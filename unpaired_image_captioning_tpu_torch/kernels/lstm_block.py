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
`bwd_launches` count them.
"""

from __future__ import annotations

import torch

from ..ops.lstm_block import chain_bwd_plain, chain_fwd_plain
from . import build

fwd_launches = 0
bwd_launches = 0

_TOO_LARGE = 720   # cudaErrorCooperativeLaunchTooLarge


def _check(name: str, tensors: dict, device) -> None:
    for key, (t, shape) in tensors.items():
        if t.device != device or t.dtype != torch.float32:
            raise ValueError(f"{name}: {key} must be f32 on {device}, got "
                             f"{t.dtype} on {t.device}")
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


def _raise_on(err: int, name: str, shape) -> None:
    if err == _TOO_LARGE:
        raise RuntimeError(f"{name}: the grid for {shape} cannot be "
                           f"co-resident on this card (cooperative launch "
                           f"refused)")
    build.check(err, name)


def chain_fwd(x_contrib, h0, c0, w_h2h, *, maxout: bool):
    """(hs, cs [T, B, H], gates [T, B, G*H])."""
    global fwd_launches
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
    hs = torch.empty((t, b, hidden), dtype=torch.float32,
                     device=x_contrib.device)
    cs = torch.empty_like(hs)
    gates = torch.empty_like(x_contrib)
    lib = build.load()
    stream = torch.cuda.current_stream(x_contrib.device).cuda_stream
    err = lib.lstm_chain_fwd_f32(
        x_contrib.data_ptr(), h0.data_ptr(), c0.data_ptr(), w_h2h.data_ptr(),
        hs.data_ptr(), cs.data_ptr(), gates.data_ptr(), t, b, hidden, g,
        stream)
    _raise_on(err, "lstm_chain_fwd_f32", (t, b, gh))
    fwd_launches += 1
    return hs, cs, gates


def chain_bwd(gates, cs, c0, dhs, dcs, w_h2h, *, maxout: bool):
    """(dgates [T, B, G*H], dh0, dc0 [B, H])."""
    global bwd_launches
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
    dgates = torch.empty_like(gates)
    dh0 = torch.empty_like(c0)
    dc0 = torch.empty_like(c0)
    lib = build.load()
    stream = torch.cuda.current_stream(gates.device).cuda_stream
    err = lib.lstm_chain_bwd_f32(
        gates.data_ptr(), cs.data_ptr(), c0.data_ptr(), dhs.data_ptr(),
        dcs.data_ptr(), w_h2h.data_ptr(), dgates.data_ptr(), dh0.data_ptr(),
        dc0.data_ptr(), t, b, hidden, g, stream)
    _raise_on(err, "lstm_chain_bwd_f32", (t, b, gh))
    bwd_launches += 1
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
            hs_prev = torch.cat([h0[None], hs[:-1]], dim=0)
            dw = torch.matmul(hs_prev.reshape(-1, hs.shape[-1]).t(),
                              dgates.reshape(-1, gates.shape[-1]))
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
