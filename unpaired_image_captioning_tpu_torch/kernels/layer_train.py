"""Whole-layer training transformer layers: the wrappers of
`csrc/layer_train.cu`.

Replaces the TPU kernels `unpaired_image_captioning_tpu/ops/layer_train.py
::_fwd_kernel`, `::_bwd_ffn_kernel` and `::_bwd_attn_kernel`
(`fused_enc_layer`) and `::_dec_fwd_kernel` and `::_bwd_cross_kernel`
(`fused_dec_layer`, whose backward reuses the encoder's two programs). The
plain versions and the semantics, the dropout sites included, are in
`ops/layer_train.py`.

`enc_layer_train` and `dec_layer_train` are the differentiable entry
points (`torch.autograd.Function`s whose backward is the backward kernel).
The four wrappers below run the plain versions for CPU tensors and launch
the kernels for CUDA tensors; they never route a CUDA tensor to the plain
version. Each launch is one C call that runs the layer as a fixed sequence
of short kernels. `enc_fwd_launches`, `enc_bwd_launches`,
`dec_fwd_launches` and `dec_bwd_launches` count the calls.

What the forward keeps for the backward: the plain version keeps x2 (and
x3) and its backward recomputes the rest, as the Pallas kernel does; the
kernel keeps the LayerNorm outputs, the packed qkv (the cross query), the
attention outputs, the attentions' row softmax statistics [2, B, H, T] and
the dropped FFN hidden as well, so its backward runs no product of the
forward again. The dropped FFN hidden is the last saved tensor.

Any head width, d and d_ff: widths that are not multiples of 4 run the
kernels' 4-byte-copy instances (`csrc/train_gemm.cuh`, `csrc/mha_train.cu`).

Types (the compute dtype, ROADMAP A15): a call is all f32 or all bf16 (x,
mk, mv, g and every weight; the masks f32), as the TPU kernel runs under a
bf16 copy of the parameters; the outputs come in x's type and each weight's
gradient in its weight's type. The kernel's saved activations come in x's
type too, as the TPU kernel holds them, but for the softmax statistics,
which stay f32. Any other mixture raises, naming it. `tensor_core` is the
routing rule: a bf16 call runs its products on the tensor-core instance of
`csrc/train_gemm.cuh` (bf16 operands, f32 accumulators), an f32 call on
the f32 FMA core. `bf16_*_launches` count the bf16 calls, `tc_*_launches`
the calls whose products ran on the tensor cores. The layers' attention
runs B5's launchers (`kernels/mha_train.py`) under B5's rule
(`mha_train.tensor_core`): `tc_attn_fwd_launches` and
`tc_attn_bwd_launches` count the attention calls inside the layer calls
(one an encoder layer, two a decoder layer) that took B5's tensor-core
instance.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.layer_train import (DEC_WEIGHTS, ENC_WEIGHTS, dec_bwd_plain,
                               dec_fwd_plain, enc_bwd_plain, enc_fwd_plain)
from ..ops.mha_train import keep_threshold
from . import build
from .mha_train import check_head_width
from .mha_train import tensor_core as attn_tensor_core

enc_fwd_launches = 0
enc_bwd_launches = 0
dec_fwd_launches = 0
dec_bwd_launches = 0
bf16_enc_fwd_launches = 0
bf16_enc_bwd_launches = 0
bf16_dec_fwd_launches = 0
bf16_dec_bwd_launches = 0
tc_enc_fwd_launches = 0
tc_enc_bwd_launches = 0
tc_dec_fwd_launches = 0
tc_dec_bwd_launches = 0
tc_attn_fwd_launches = 0
tc_attn_bwd_launches = 0

ENC, DEC = 0, 1   # `kind` of the C workspace query
ACT = None        # in `_check`'s dtype column: x's type


def tensor_core(dtype: torch.dtype) -> bool:
    """The routing rule: whether a call whose tensors are all of `dtype`
    runs its products on the tensor cores. Only bf16 does: the f32 route's
    products are f32 products, as in JAX."""
    return dtype == torch.bfloat16


def _rate_args(rate: float):
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate {rate} outside [0, 1)")
    return keep_threshold(rate), float(1.0 - rate), int(rate > 0.0)


def _weight_shapes(d: int, f: int) -> dict:
    return {"wqkv": (d, 3 * d), "bqkv": (3 * d,), "wo": (d, d), "wq": (d, d),
            "wo2": (d, d), "w1": (d, f), "b1": (f,), "w2": (f, d)}


def _check(name: str, x, w: dict, keys, n_heads: int, arrays: dict) -> int:
    """Device, dtype, shape, contiguity and alignment of every tensor the
    kernel reads; the widths the kernel takes. Returns the kernel's bf
    flag (every tensor of x's type bf16); raises, naming the mixture, where
    x, the weights and the activations (dtype ACT) are not all f32 or all
    bf16."""
    b, t, d = x.shape
    f = w["w1"].shape[1]
    check_head_width(name, d, n_heads)
    shapes = _weight_shapes(d, f)
    tensors = {"x": (x, (b, t, d), ACT)}
    tensors.update({k: (w[k], shapes.get(k, (d,)), ACT) for k in keys})
    tensors.update(arrays)
    typed = {key: a.dtype for key, (a, _, dtype) in tensors.items()
             if dtype is ACT}
    if (x.dtype not in (torch.float32, torch.bfloat16)
            or any(dt != x.dtype for dt in typed.values())):
        raise ValueError(
            f"{name}: no kernel entry for the mixture "
            + ", ".join(f"{key} {dt}" for key, dt in typed.items())
            + ": x, the activations and every weight all float32 or all "
            "bfloat16")
    for key, (a, shape, dtype) in tensors.items():
        dtype = x.dtype if dtype is ACT else dtype
        if a.device != x.device or a.dtype != dtype:
            raise ValueError(f"{name}: {key} must be {dtype} on {x.device}, "
                             f"got {a.dtype} on {a.device}")
        if tuple(a.shape) != tuple(shape):
            raise ValueError(f"{name}: {key} has shape {tuple(a.shape)}, "
                             f"expected {tuple(shape)}")
        if not a.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if a.data_ptr() % 16:
            raise ValueError(f"{name}: {key} must start on a 16-byte "
                             "boundary (the kernel loads float4 rows where "
                             "the widths allow)")
    return int(x.dtype == torch.bfloat16)


def _mask_arrays(name: str, key: str, maskadd, b: int, t: int, s: int):
    if s < 1 or t < 1:
        raise ValueError(f"{name}: {t} queries over {s} keys; the kernel "
                         "takes at least one of each")
    rows = maskadd.shape[1] if maskadd.dim() == 3 else -1
    if rows not in (1, t):
        raise ValueError(f"{name}: {key} has shape {tuple(maskadd.shape)}, "
                         f"expected ({b}, 1|{t}, {s})")
    return {key: (maskadd, (b, rows, s), torch.float32)}


def _ptrs(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*[a.data_ptr() for a in tensors])


def _launch(fn_name: str, x, ptrs, ints, rate: float, bf: int,
            ws_kind=None, ws_dims=None) -> None:
    """One C call; a backward (ws_kind) takes the scratch of its kind and
    ws_dims (B, T, S, d, f, H), partly in x's type (bf)."""
    lib = build.load()
    thresh, keep_div, dropout = _rate_args(rate)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    extra = []
    if ws_kind is not None:
        n = ctypes.c_int64()
        lib.layer_train_ws_f32(ws_kind, *ws_dims, bf, ctypes.byref(n))
        ws = torch.empty((n.value,), dtype=torch.float32, device=x.device)
        extra = [ws.data_ptr()]
    err = getattr(lib, fn_name)(
        _ptrs(ptrs), *ints, thresh, keep_div, dropout, bf, *extra, stream)
    build.check(err, fn_name)


def enc_layer_fwd(x, maskadd, seed, w: dict, *, n_heads: int, rate: float):
    """(out [B, T, d], saved): one encoder layer; `saved` is what
    `enc_layer_bwd` takes. w holds the ENC_WEIGHTS."""
    global enc_fwd_launches, bf16_enc_fwd_launches, tc_enc_fwd_launches
    global tc_attn_fwd_launches
    ws = [w[k] for k in ENC_WEIGHTS]
    if x.device.type == "cpu":
        out, x2 = enc_fwd_plain(x, maskadd, seed, *ws, n_heads=n_heads,
                                rate=rate)
        return out, (x2,)
    if x.device.type != "cuda":
        raise ValueError(f"enc_layer_fwd: unsupported device {x.device}")
    b, t, d = x.shape
    f = w["w1"].shape[1]
    arrays = _mask_arrays("enc_layer_fwd", "maskadd", maskadd, b, t, t)
    arrays["seed"] = (seed, (1,), torch.int32)
    bf = _check("enc_layer_fwd", x, w, ENC_WEIGHTS, n_heads, arrays)
    out = torch.empty_like(x)
    x2, y1, ao, y2 = (_act(x, (b, t, d)) for _ in range(4))
    saved = (x2, y1, _act(x, (b, t, 3 * d)), ao,
             _f32(x, (2, b, n_heads, t)), y2, _act(x, (b, t, f)))
    _launch("enc_layer_fwd_mixed", x, [x, maskadd, seed, *ws, out, *saved],
            (b, t, d, f, n_heads, maskadd.shape[1]), rate, bf)
    enc_fwd_launches += 1
    bf16_enc_fwd_launches += bf
    tc_enc_fwd_launches += tensor_core(x.dtype)
    tc_attn_fwd_launches += attn_tensor_core(x.dtype, d // n_heads)
    return out, saved


def enc_layer_bwd(x, maskadd, seed, w: dict, saved, g, *, n_heads: int,
                  rate: float):
    """(dx, then the gradients of the ENC_WEIGHTS in order) for the
    upstream gradient g [B, T, d]."""
    global enc_bwd_launches, bf16_enc_bwd_launches, tc_enc_bwd_launches
    global tc_attn_bwd_launches
    ws = [w[k] for k in ENC_WEIGHTS]
    if x.device.type == "cpu":
        return enc_bwd_plain(x, maskadd, seed, saved[0], g, *ws,
                             n_heads=n_heads, rate=rate)
    if x.device.type != "cuda":
        raise ValueError(f"enc_layer_bwd: unsupported device {x.device}")
    b, t, d = x.shape
    f = w["w1"].shape[1]
    arrays = _mask_arrays("enc_layer_bwd", "maskadd", maskadd, b, t, t)
    arrays["seed"] = (seed, (1,), torch.int32)
    arrays["g"] = (g, (b, t, d), ACT)
    bf = _check("enc_layer_bwd", x, w, ENC_WEIGHTS, n_heads, arrays)
    grads = [torch.empty_like(x)] + [torch.empty_like(a) for a in ws]
    _launch("enc_layer_bwd_mixed", x,
            [x, maskadd, seed, *ws, *saved, g, *grads],
            (b, t, d, f, n_heads, maskadd.shape[1]), rate, bf, ENC,
            (b, t, t, d, f, n_heads))
    enc_bwd_launches += 1
    bf16_enc_bwd_launches += bf
    tc_enc_bwd_launches += tensor_core(x.dtype)
    tc_attn_bwd_launches += attn_tensor_core(x.dtype, d // n_heads)
    return tuple(grads)


def dec_layer_fwd(x, mk, mv, tgt_maskadd, src_maskadd, seeds, w: dict, *,
                  n_heads: int, rate: float):
    """(out [B, T, d], saved): one decoder layer over the memory's K/V
    projections mk / mv [B, S, d]; w holds the DEC_WEIGHTS."""
    global dec_fwd_launches, bf16_dec_fwd_launches, tc_dec_fwd_launches
    global tc_attn_fwd_launches
    ws = [w[k] for k in DEC_WEIGHTS]
    if x.device.type == "cpu":
        out, x2, x3 = dec_fwd_plain(x, mk, mv, tgt_maskadd, src_maskadd,
                                    seeds, *ws, n_heads=n_heads, rate=rate)
        return out, (x2, x3)
    if x.device.type != "cuda":
        raise ValueError(f"dec_layer_fwd: unsupported device {x.device}")
    b, t, d = x.shape
    s = mk.shape[1]
    f = w["w1"].shape[1]
    arrays = _dec_arrays("dec_layer_fwd", mk, mv, tgt_maskadd, src_maskadd,
                         seeds, b, t, s, d)
    bf = _check("dec_layer_fwd", x, w, DEC_WEIGHTS, n_heads, arrays)
    out = torch.empty_like(x)
    x2, x3, y1, ao, y2, qc, co, y3 = (_act(x, (b, t, d)) for _ in range(8))
    qkv = _act(x, (b, t, 3 * d))
    stats_self, stats_cross = (_f32(x, (2, b, n_heads, t))
                               for _ in range(2))
    saved = (x2, x3, y1, qkv, ao, y2, qc, co, y3, stats_self, stats_cross,
             _act(x, (b, t, f)))
    _launch("dec_layer_fwd_mixed", x,
            [x, mk, mv, tgt_maskadd, src_maskadd, seeds, *ws, out, *saved],
            (b, t, s, d, f, n_heads, tgt_maskadd.shape[1]), rate, bf)
    dec_fwd_launches += 1
    bf16_dec_fwd_launches += bf
    tc_dec_fwd_launches += tensor_core(x.dtype)
    tc_attn_fwd_launches += 2 * attn_tensor_core(x.dtype, d // n_heads)
    return out, saved


def dec_layer_bwd(x, mk, mv, tgt_maskadd, src_maskadd, seeds, w: dict,
                  saved, g, *, n_heads: int, rate: float):
    """(dx, dmk, dmv, then the gradients of the DEC_WEIGHTS in order)."""
    global dec_bwd_launches, bf16_dec_bwd_launches, tc_dec_bwd_launches
    global tc_attn_bwd_launches
    ws = [w[k] for k in DEC_WEIGHTS]
    if x.device.type == "cpu":
        return dec_bwd_plain(x, mk, mv, tgt_maskadd, src_maskadd, seeds,
                             saved[0], saved[1], g, *ws, n_heads=n_heads,
                             rate=rate)
    if x.device.type != "cuda":
        raise ValueError(f"dec_layer_bwd: unsupported device {x.device}")
    b, t, d = x.shape
    s = mk.shape[1]
    f = w["w1"].shape[1]
    arrays = _dec_arrays("dec_layer_bwd", mk, mv, tgt_maskadd, src_maskadd,
                         seeds, b, t, s, d)
    arrays["g"] = (g, (b, t, d), ACT)
    bf = _check("dec_layer_bwd", x, w, DEC_WEIGHTS, n_heads, arrays)
    grads = ([torch.empty_like(x), torch.empty_like(mk), torch.empty_like(mv)]
             + [torch.empty_like(a) for a in ws])
    _launch("dec_layer_bwd_mixed", x,
            [x, mk, mv, tgt_maskadd, src_maskadd, seeds, *ws, *saved, g,
             *grads],
            (b, t, s, d, f, n_heads, tgt_maskadd.shape[1]), rate, bf,
            DEC, (b, t, s, d, f, n_heads))
    dec_bwd_launches += 1
    bf16_dec_bwd_launches += bf
    tc_dec_bwd_launches += tensor_core(x.dtype)
    tc_attn_bwd_launches += 2 * attn_tensor_core(x.dtype, d // n_heads)
    return tuple(grads)


def _dec_arrays(name, mk, mv, tgt_maskadd, src_maskadd, seeds, b, t, s, d):
    arrays = _mask_arrays(name, "tgt_maskadd", tgt_maskadd, b, t, t)
    if tuple(src_maskadd.shape) != (b, 1, s):
        raise ValueError(f"{name}: src_maskadd has shape "
                         f"{tuple(src_maskadd.shape)}, expected ({b}, 1, {s})")
    arrays.update(_mask_arrays(name, "src_maskadd", src_maskadd, b, t, s))
    arrays.update(mk=(mk, (b, s, d), ACT), mv=(mv, (b, s, d), ACT),
                  seeds=(seeds, (2,), torch.int32))
    return arrays


def _f32(x, shape):
    """An f32 array of the kernel's saved softmax statistics, on x's
    device."""
    return torch.empty(shape, dtype=torch.float32, device=x.device)


def _act(x, shape):
    """A saved activation of the kernel, in x's type and on its device."""
    return torch.empty(shape, dtype=x.dtype, device=x.device)


class _EncLayer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, maskadd, seed, n_heads, rate, *ws):
        w = dict(zip(ENC_WEIGHTS, ws))
        out, saved = enc_layer_fwd(x, maskadd, seed, w, n_heads=n_heads,
                                   rate=rate)
        ctx.save_for_backward(x, maskadd, seed, *ws, *saved)
        ctx.n_heads, ctx.rate = n_heads, rate
        return out

    @staticmethod
    def backward(ctx, g):
        x, maskadd, seed, *rest = ctx.saved_tensors
        n = len(ENC_WEIGHTS)
        w = dict(zip(ENC_WEIGHTS, rest[:n]))
        dx, *dws = enc_layer_bwd(x, maskadd, seed, w, tuple(rest[n:]),
                                 g.contiguous(), n_heads=ctx.n_heads,
                                 rate=ctx.rate)
        return (dx, None, None, None, None, *dws)


class _DecLayer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mk, mv, tgt_maskadd, src_maskadd, seeds, n_heads,
                rate, *ws):
        w = dict(zip(DEC_WEIGHTS, ws))
        out, saved = dec_layer_fwd(x, mk, mv, tgt_maskadd, src_maskadd,
                                   seeds, w, n_heads=n_heads, rate=rate)
        ctx.save_for_backward(x, mk, mv, tgt_maskadd, src_maskadd, seeds,
                              *ws, *saved)
        ctx.n_heads, ctx.rate = n_heads, rate
        return out

    @staticmethod
    def backward(ctx, g):
        x, mk, mv, tm, sm, seeds, *rest = ctx.saved_tensors
        n = len(DEC_WEIGHTS)
        w = dict(zip(DEC_WEIGHTS, rest[:n]))
        dx, dmk, dmv, *dws = dec_layer_bwd(
            x, mk, mv, tm, sm, seeds, w, tuple(rest[n:]), g.contiguous(),
            n_heads=ctx.n_heads, rate=ctx.rate)
        return (dx, dmk, dmv, None, None, None, None, None, *dws)


def enc_layer_train(x, maskadd, seed, wqkv, bqkv, wo, bo, w1, b1, w2, b2,
                    l1s, l1b, l2s, l2b, *, n_heads: int, rate: float):
    """Differentiable pre-norm encoder layer with the arguments of the
    Pallas `fused_enc_layer`: x [B, T, d]; maskadd [B, 1|T, T] f32
    additive; seed int32 [1]; wqkv [d, 3d] (q | k | v), bqkv [3d]; wo [d, d],
    bo; w1 [d, f], b1; w2 [f, d], b2; LayerNorm vectors [d]. Gradients flow
    to x and every weight."""
    return _EncLayer.apply(x, maskadd, seed, n_heads, rate, wqkv, bqkv, wo,
                           bo, w1, b1, w2, b2, l1s, l1b, l2s, l2b)


def dec_layer_train(x, mk, mv, tgt_maskadd, src_maskadd, seeds, wqkv, bqkv,
                    wo, bo, wq, bq, wo2, bo2, w1, b1, w2, b2, l1s, l1b, l2s,
                    l2b, l3s, l3b, *, n_heads: int, rate: float):
    """Differentiable pre-norm decoder layer with the arguments of the
    Pallas `fused_dec_layer`: mk / mv [B, S, d] the memory's K/V
    projections; tgt_maskadd [B, 1|T, T]; src_maskadd [B, 1, S]; seeds
    int32 [2] (seeds[1] the cross sublayer's stream). Gradients flow to x,
    mk, mv and every weight."""
    return _DecLayer.apply(x, mk, mv, tgt_maskadd, src_maskadd, seeds,
                           n_heads, rate, wqkv, bqkv, wo, bo, wq, bq, wo2,
                           bo2, w1, b1, w2, b2, l1s, l1b, l2s, l2b, l3s, l3b)
