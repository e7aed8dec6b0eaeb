"""Training multi-head attention: the wrappers of `csrc/mha_train.cu`.

Replaces the TPU kernels `unpaired_image_captioning_tpu/ops/mha_train.py
::_fwd_kernel` and `::_bwd_kernel` (`fused_mha_train`). The plain versions
and the semantics, the dropout hash included, are in `ops/mha_train.py`.

`mha_train` is the differentiable entry point (a `torch.autograd.Function`
whose backward is the backward kernel). `mha_train_fwd` and `mha_train_bwd`
run the plain versions for CPU tensors and launch the kernels for CUDA
tensors; they never route a CUDA tensor to the plain version. The forward
also returns the rows' softmax statistics [2, B, H, T] (`ops.mha_train.
softmax_stats`), which the backward kernel reads instead of recomputing
whole rows; the plain backward ignores them. `fwd_launches` and
`bwd_launches` count kernel launches, `bf16_fwd_launches` and
`bf16_bwd_launches` those of them on bf16 operands, `tc_fwd_launches` and
`tc_bwd_launches` those on the tensor-core instance.

Types (the compute dtype, ROADMAP A15), as the TPU kernel: q, k and v are
all f32 or all bf16 (the routes give no other mixture: the per-sublayer
route attends over projections of one activation, and the cast route
casts every parameter); maskadd and the statistics stay f32; the output
and dq / dk / dv are in q's type, g and the forward output in it too. On
bf16 the kernel keeps the TPU kernel's cast points (`ops/mha_train.py`).
Any other mixture raises, naming it.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.mha_train import (keep_threshold, mha_train_plain,
                             mha_train_plain_bwd, softmax_stats)
from . import build

fwd_launches = 0
bwd_launches = 0
bf16_fwd_launches = 0
bf16_bwd_launches = 0
tc_fwd_launches = 0
tc_bwd_launches = 0
# the kernel's type flags (csrc/mha_train.cuh): q, k / v, out / g / o
# stored as bf16, and the bf16 cast points
ATT_BF16 = 1 | 2 | 4 | 8

def tensor_core(dtype: torch.dtype, dh: int) -> bool:
    """The routing rule: whether a call whose q, k, v (and g, out) are all
    of `dtype` with head width `dh` runs on the tensor-core instance, given
    rows on 16 bytes (the wrappers' contiguous tensors, whose pointers the
    wrappers check; `_aligned`). Only bf16 does, at dh a multiple of 8 up
    to 256: f32 calls multiply in f32, as in JAX."""
    return dtype == torch.bfloat16 and 8 <= dh <= 256 and dh % 8 == 0


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def check_head_width(name: str, d: int, n_heads: int) -> None:
    """Raise unless d splits into n_heads heads, as the JAX package's head
    split requires (`models/transformer.py:92`, a reshape of d into
    n_heads heads).
    Every head width runs: up to 256 in one of the compiled buckets 32, 64,
    128 and 256, wider ones in bucket 256 as column chunks, widths and rows
    off 16 bytes by 4-byte copies (`csrc/mha_train.cu`); any number of keys
    is taken."""
    if n_heads < 1 or d % n_heads:
        raise ValueError(f"{name}: d={d} does not split into {n_heads} heads")


def _check(name, q, k, v, maskadd, seed, n_heads, extra=None):
    b, t, d = q.shape
    s = k.shape[1]
    check_head_width(name, d, n_heads)
    if s < 1 or t < 1:
        raise ValueError(f"{name}: {t} queries over {s} keys; the kernel "
                         "takes at least one of each")
    shapes = {"q": (q, (b, t, d)), "k": (k, (b, s, d)), "v": (v, (b, s, d))}
    for key, x in (extra or {}).items():
        shapes[key] = (x, (b, t, d))
    if maskadd.dim() != 3 or maskadd.shape[0] != b or maskadd.shape[2] != s \
            or maskadd.shape[1] not in (1, t):
        raise ValueError(f"{name}: maskadd has shape {tuple(maskadd.shape)}, "
                         f"expected ({b}, 1|{t}, {s})")
    if (q.dtype not in (torch.float32, torch.bfloat16)
            or any(x.dtype != q.dtype for x, _ in shapes.values())
            or maskadd.dtype != torch.float32):
        raise ValueError(
            f"{name}: no kernel entry for the mixture "
            + ", ".join(f"{key} {x.dtype}" for key, (x, _) in shapes.items())
            + f", maskadd {maskadd.dtype}: q, k, v (and g, out) all float32 "
            "or all bfloat16, maskadd float32")
    shapes["maskadd"] = (maskadd, tuple(maskadd.shape))
    for key, (x, shape) in shapes.items():
        if x.device != q.device:
            raise ValueError(f"{name}: {key} must be on {q.device}, got "
                             f"{x.device}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name}: {key} has shape {tuple(x.shape)}, "
                             f"expected {shape}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    if seed.device != q.device or seed.dtype != torch.int32 \
            or seed.numel() != 1:
        raise ValueError(f"{name}: seed must be one int32 on {q.device}")


def _rate_args(rate: float):
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate {rate} outside [0, 1)")
    return keep_threshold(rate), float(1.0 - rate), int(rate > 0.0)


def mha_train_fwd(q, k, v, maskadd, seed, *, n_heads: int, rate: float):
    """(attention output [B, T, d] (see `ops.mha_train.mha_train_plain`),
    the rows' softmax statistics [2, B, H, T])."""
    global fwd_launches, bf16_fwd_launches, tc_fwd_launches
    if q.device.type == "cpu":
        return (mha_train_plain(q, k, v, maskadd, seed, n_heads=n_heads,
                                rate=rate),
                softmax_stats(q, k, maskadd, n_heads=n_heads))
    if q.device.type != "cuda":
        raise ValueError(f"mha_train_fwd: unsupported device {q.device}")
    _check("mha_train_fwd", q, k, v, maskadd, seed, n_heads)
    b, t, d = q.shape
    thresh, keep_div, dropout = _rate_args(rate)
    fl = ATT_BF16 if q.dtype == torch.bfloat16 else 0
    out = torch.empty_like(q)
    stats = torch.empty((2, b, n_heads, t), dtype=torch.float32,
                        device=q.device)
    lib = build.load()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.mha_train_fwd_mixed(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), maskadd.data_ptr(),
        seed.data_ptr(), out.data_ptr(), stats.data_ptr(), b, t, k.shape[1],
        n_heads, d // n_heads, maskadd.shape[1], thresh, keep_div, dropout,
        fl, stream)
    build.check(err, "mha_train_fwd_mixed")
    fwd_launches += 1
    bf16_fwd_launches += fl != 0
    tc_fwd_launches += (tensor_core(q.dtype, d // n_heads)
                        and _aligned(q, k, v, out))
    return out, stats


def mha_train_bwd(q, k, v, maskadd, seed, g, out, stats, *, n_heads: int,
                  rate: float):
    """(dq, dk, dv) for the upstream gradient g [B, T, d]; `out` and
    `stats` are the forward's output and row statistics, which the kernel
    reads for the softmax backward (the plain version recomputes both)."""
    global bwd_launches, bf16_bwd_launches, tc_bwd_launches
    if q.device.type == "cpu":
        return mha_train_plain_bwd(q, k, v, maskadd, seed, g,
                                   n_heads=n_heads, rate=rate)
    if q.device.type != "cuda":
        raise ValueError(f"mha_train_bwd: unsupported device {q.device}")
    _check("mha_train_bwd", q, k, v, maskadd, seed, n_heads,
           {"g": g, "out": out})
    b, t, d = q.shape
    s = k.shape[1]
    if (stats.device != q.device or stats.dtype != torch.float32
            or tuple(stats.shape) != (2, b, n_heads, t)
            or not stats.is_contiguous()):
        raise ValueError(f"mha_train_bwd: stats must be f32 [2, {b}, "
                         f"{n_heads}, {t}] on {q.device}, contiguous")
    thresh, keep_div, dropout = _rate_args(rate)
    fl = ATT_BF16 if q.dtype == torch.bfloat16 else 0
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    tc = (tensor_core(q.dtype, d // n_heads)
          and _aligned(q, k, v, g, out, dq, dk, dv))
    lib = build.load()
    n = ctypes.c_int64()
    lib.mha_train_bwd_ws_bytes(b, t, s, n_heads, int(tc), ctypes.byref(n))
    scratch = torch.empty((n.value,), dtype=torch.uint8, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.mha_train_bwd_mixed(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), maskadd.data_ptr(),
        seed.data_ptr(), g.data_ptr(), out.data_ptr(), stats.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), scratch.data_ptr(),
        n.value, b, t, s, n_heads, d // n_heads, maskadd.shape[1], thresh,
        keep_div, dropout, fl, stream)
    build.check(err, "mha_train_bwd_mixed")
    bwd_launches += 1
    bf16_bwd_launches += fl != 0
    tc_bwd_launches += tc
    return dq, dk, dv


class _MhaTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, maskadd, seed, n_heads, rate):
        out, stats = mha_train_fwd(q, k, v, maskadd, seed, n_heads=n_heads,
                                   rate=rate)
        ctx.save_for_backward(q, k, v, maskadd, seed, out, stats)
        ctx.n_heads, ctx.rate = n_heads, rate
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, maskadd, seed, out, stats = ctx.saved_tensors
        dq, dk, dv = mha_train_bwd(q, k, v, maskadd, seed, g.contiguous(),
                                   out, stats, n_heads=ctx.n_heads,
                                   rate=ctx.rate)
        return dq, dk, dv, None, None, None, None


def mha_train(q, k, v, maskadd, seed, *, n_heads: int, rate: float):
    """Differentiable training attention: q [B, T, d], k / v [B, S, d] (all
    f32 or all bf16), maskadd [B, 1|T, S] f32, seed int32 [1]; returns
    [B, T, d] in q's type. Gradients flow to q, k and v."""
    return _MhaTrain.apply(q, k, v, maskadd, seed, n_heads, rate)

