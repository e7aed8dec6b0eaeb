"""Training multi-head attention: the wrappers of `csrc/mha_train.cu`.

Replaces the TPU kernels `unpaired_image_captioning_tpu/ops/mha_train.py
::_fwd_kernel` and `::_bwd_kernel` (`fused_mha_train`). The plain versions
and the semantics, the dropout hash included, are in `ops/mha_train.py`.

`mha_train` is the differentiable entry point (a `torch.autograd.Function`
whose backward is the backward kernel). `mha_train_fwd` and `mha_train_bwd`
run the plain versions for CPU tensors and launch the kernels for CUDA
tensors; they never route a CUDA tensor to the plain version.
`fwd_launches` and `bwd_launches` count kernel launches.
"""

from __future__ import annotations

import torch

from ..ops.mha_train import (keep_threshold, mha_train_plain,
                             mha_train_plain_bwd)
from . import build

fwd_launches = 0
bwd_launches = 0

HEAD_DIMS = (32, 64, 128)   # the head widths the CUDA kernels are built for
MAX_KEYS = 1024             # whole score rows of 32 queries in shared memory


def _check(name, q, k, v, maskadd, seed, n_heads, extra=None):
    b, t, d = q.shape
    s = k.shape[1]
    if d % n_heads or d // n_heads not in HEAD_DIMS:
        raise ValueError(f"{name}: d={d} over {n_heads} heads gives a head "
                         f"width the kernel does not take (one of "
                         f"{HEAD_DIMS})")
    if s > MAX_KEYS or s < 1 or t < 1:
        raise ValueError(f"{name}: {s} keys; the kernel takes 1 to "
                         f"{MAX_KEYS}")
    shapes = {"q": (q, (b, t, d)), "k": (k, (b, s, d)), "v": (v, (b, s, d))}
    for key, x in (extra or {}).items():
        shapes[key] = (x, (b, t, d))
    if maskadd.dim() != 3 or maskadd.shape[0] != b or maskadd.shape[2] != s \
            or maskadd.shape[1] not in (1, t):
        raise ValueError(f"{name}: maskadd has shape {tuple(maskadd.shape)}, "
                         f"expected ({b}, 1|{t}, {s})")
    shapes["maskadd"] = (maskadd, tuple(maskadd.shape))
    for key, (x, shape) in shapes.items():
        if x.device != q.device or x.dtype != torch.float32:
            raise ValueError(f"{name}: {key} must be f32 on {q.device}, got "
                             f"{x.dtype} on {x.device}")
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
    """Attention output [B, T, d] (see `ops.mha_train.mha_train_plain`)."""
    global fwd_launches
    if q.device.type == "cpu":
        return mha_train_plain(q, k, v, maskadd, seed, n_heads=n_heads,
                               rate=rate)
    if q.device.type != "cuda":
        raise ValueError(f"mha_train_fwd: unsupported device {q.device}")
    _check("mha_train_fwd", q, k, v, maskadd, seed, n_heads)
    b, t, d = q.shape
    thresh, keep_div, dropout = _rate_args(rate)
    out = torch.empty_like(q)
    lib = build.load()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.mha_train_fwd_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), maskadd.data_ptr(),
        seed.data_ptr(), out.data_ptr(), b, t, k.shape[1], n_heads,
        d // n_heads, maskadd.shape[1], thresh, keep_div, dropout, stream)
    build.check(err, "mha_train_fwd_f32")
    fwd_launches += 1
    return out


def mha_train_bwd(q, k, v, maskadd, seed, g, out, *, n_heads: int,
                  rate: float):
    """(dq, dk, dv) for the upstream gradient g [B, T, d]; `out` is the
    forward's output, which the kernel reads for the softmax backward's row
    term (the plain version recomputes it)."""
    global bwd_launches
    if q.device.type == "cpu":
        return mha_train_plain_bwd(q, k, v, maskadd, seed, g,
                                   n_heads=n_heads, rate=rate)
    if q.device.type != "cuda":
        raise ValueError(f"mha_train_bwd: unsupported device {q.device}")
    _check("mha_train_bwd", q, k, v, maskadd, seed, n_heads,
           {"g": g, "out": out})
    b, t, d = q.shape
    s = k.shape[1]
    thresh, keep_div, dropout = _rate_args(rate)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    stats = torch.empty((b * n_heads * t * 3,), dtype=torch.float32,
                        device=q.device)
    lib = build.load()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.mha_train_bwd_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), maskadd.data_ptr(),
        seed.data_ptr(), g.data_ptr(), out.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), stats.data_ptr(), b, t, s, n_heads,
        d // n_heads, maskadd.shape[1], thresh, keep_div, dropout, stream)
    build.check(err, "mha_train_bwd_f32")
    bwd_launches += 1
    return dq, dk, dv


class _MhaTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, maskadd, seed, n_heads, rate):
        out = mha_train_fwd(q, k, v, maskadd, seed, n_heads=n_heads,
                            rate=rate)
        ctx.save_for_backward(q, k, v, maskadd, seed, out)
        ctx.n_heads, ctx.rate = n_heads, rate
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, maskadd, seed, out = ctx.saved_tensors
        dq, dk, dv = mha_train_bwd(q, k, v, maskadd, seed, g.contiguous(),
                                   out, n_heads=ctx.n_heads, rate=ctx.rate)
        return dq, dk, dv, None, None, None, None


def mha_train(q, k, v, maskadd, seed, *, n_heads: int, rate: float):
    """Differentiable training attention: q [B, T, d], k / v [B, S, d],
    maskadd [B, 1|T, S] f32, seed int32 [1]; returns [B, T, d]. Gradients
    flow to q, k and v."""
    return _MhaTrain.apply(q, k, v, maskadd, seed, n_heads, rate)

