"""Transformer decoder step: the wrappers of `csrc/transformer_decode.cu`.

Replaces the TPU kernels `unpaired_image_captioning_tpu/ops/
transformer_decode.py::_stack_kernel` (all L decoder layers of one decode
step, `decoder_stack_step`) and `::_layer_kernel` (one layer,
`decoder_layer_step`). The plain versions and the weight packing are in
`ops/transformer_decode.py`, which states the semantics and the in-place
cache contract the kernel shares.

Each wrapper runs the plain version for CPU tensors and launches the kernel
for CUDA tensors (one C call per step: the layer loop runs in C); it never
routes a CUDA tensor to the plain version. `stack_launches` and
`layer_launches` count kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.transformer_decode import (WKEYS, decoder_layer_step_plain,
                                      decoder_stack_step_plain, src_mask_2d)
from . import build

stack_launches = 0
layer_launches = 0


def _check(name: str, tensors: dict, device) -> None:
    for key, (t, shape, dtype) in tensors.items():
        if t.device != device or t.dtype != dtype:
            raise ValueError(f"{name}: {key} must be {dtype} on {device}, "
                             f"got {t.dtype} on {t.device}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} must start on a 16-byte "
                             "boundary (the kernel loads float4)")


def _check_dims(name: str, rows: int, bsz: int, d: int, dff: int,
                n_heads: int, slots: int, n_t: int) -> None:
    """Raise for a shape the kernels do not take; the limits are the CUDA
    source's own (`tfd_refuses`)."""
    if bsz <= 0 or rows % bsz:
        raise ValueError(f"{name}: {rows} rows are not a whole number of "
                         f"beams over {bsz} images")
    if n_heads <= 0 or d % n_heads:
        raise ValueError(f"{name}: d={d} does not split into {n_heads} "
                         "heads")
    kb, dh = rows // bsz, d // n_heads
    smem = (ctypes.c_longlong * 2)()
    why = build.load().tfd_refuses(kb, d, dff, n_heads, slots, n_t, smem)
    if why == 1:
        raise ValueError(f"{name}: head width {dh} (d={d} over {n_heads} "
                         "heads) must be a multiple of 4 (16-byte rows) and "
                         "at most 256")
    if why == 2:
        raise ValueError(f"{name}: d_ff={dff} must be a multiple of 4 "
                         "(16-byte rows)")
    if why == 3:
        raise ValueError(f"{name}: {n_t} cache slots need {smem[0]} B of "
                         "self-attention shared memory, more than a block "
                         "can hold")
    if why:
        raise ValueError(f"{name}: cross-attention over {slots} slots at "
                         f"{kb} beams needs {smem[1]} B of shared memory, "
                         "more than a block can hold")


def _weights(name: str, w: dict, lead: tuple, d: int, dff: int, device):
    shapes = {"wqkv": (d, 3 * d), "bqkv": (3 * d,), "wo_s": (d, d),
              "wq_c": (d, d), "wo_c": (d, d), "w1": (d, dff), "b1": (dff,),
              "w2": (dff, d)}
    _check(name, {k: (w[k], lead + shapes.get(k, (d,)), torch.float32)
                  for k in WKEYS}, device)
    return (ctypes.c_void_p * len(WKEYS))(*[w[k].data_ptr() for k in WKEYS])


def decoder_stack_step(x, t, ck_all, cv_all, src_mask, cache_k, cache_v,
                       wstack, anc=None, *, n_heads: int,
                       want_attn: bool = False):
    """All L decoder layers for one decode step; see
    `ops.transformer_decode.decoder_stack_step_plain` for the arguments.
    On CUDA: x, ck_all, cv_all, cache_k, cache_v and the weights f32, t and
    anc int32, all contiguous; the caches are written in place."""
    global stack_launches
    if x.device.type == "cpu":
        return decoder_stack_step_plain(x, t, ck_all, cv_all, src_mask,
                                        cache_k, cache_v, wstack, anc,
                                        n_heads=n_heads, want_attn=want_attn)
    if x.device.type != "cuda":
        raise ValueError(f"decoder_stack_step: unsupported device {x.device}")
    name = "decoder_stack_step"
    rows, d = x.shape
    n_layers, bsz, slots, _ = ck_all.shape
    n_t = cache_k.shape[2]
    dff = wstack["w1"].shape[2]
    _check_dims(name, rows, bsz, d, dff, n_heads, slots, n_t)
    mask = src_mask_2d(src_mask, bsz, slots, x.device)
    f32, i32 = torch.float32, torch.int32
    arrays = {"x": (x, (rows, d), f32), "t": (t, (rows,), i32),
              "ck_all": (ck_all, (n_layers, bsz, slots, d), f32),
              "cv_all": (cv_all, (n_layers, bsz, slots, d), f32),
              "src_mask": (mask, (bsz, slots), f32),
              "cache_k": (cache_k, (rows, n_layers, n_t, d), f32),
              "cache_v": (cache_v, (rows, n_layers, n_t, d), f32)}
    if anc is not None:
        arrays["anc"] = (anc, (rows, n_t), i32)
    _check(name, arrays, x.device)
    wptr = _weights(name, wstack, (n_layers,), d, dff, x.device)
    x_out = torch.empty_like(x)
    q = torch.empty_like(x)
    att = torch.empty_like(x)
    h1 = torch.empty((rows, dff), dtype=f32, device=x.device)
    attn_h = attn = None
    if want_attn:
        attn_h = torch.empty((rows, n_heads, slots), dtype=f32,
                             device=x.device)
        attn = torch.empty((rows, slots), dtype=f32, device=x.device)
    lib = build.load()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.tfd_stack_step_f32(
        x.data_ptr(), x_out.data_ptr(), t.data_ptr(), ck_all.data_ptr(),
        cv_all.data_ptr(), mask.data_ptr(), cache_k.data_ptr(),
        cache_v.data_ptr(), None if anc is None else anc.data_ptr(), wptr,
        q.data_ptr(), att.data_ptr(), h1.data_ptr(),
        None if attn_h is None else attn_h.data_ptr(),
        None if attn is None else attn.data_ptr(),
        rows, bsz, slots, d, n_t, dff, n_heads, n_layers, stream)
    build.check(err, "tfd_stack_step_f32")
    stack_launches += 1
    if want_attn:
        return x_out, cache_k, cache_v, attn
    return x_out, cache_k, cache_v


def decoder_layer_step(x, t, ck, cv, src_mask, cache_k, cache_v, wpack, *,
                       n_heads: int):
    """One decoder layer for one decode step; see
    `ops.transformer_decode.decoder_layer_step_plain` for the arguments.
    On CUDA the tensors are as for `decoder_stack_step`, without the layer
    axis; the caches are written in place."""
    global layer_launches
    if x.device.type == "cpu":
        return decoder_layer_step_plain(x, t, ck, cv, src_mask, cache_k,
                                        cache_v, wpack, n_heads=n_heads)
    if x.device.type != "cuda":
        raise ValueError(f"decoder_layer_step: unsupported device {x.device}")
    name = "decoder_layer_step"
    rows, d = x.shape
    bsz, slots, _ = ck.shape
    n_t = cache_k.shape[1]
    dff = wpack["w1"].shape[1]
    _check_dims(name, rows, bsz, d, dff, n_heads, slots, n_t)
    mask = src_mask_2d(src_mask, bsz, slots, x.device)
    f32 = torch.float32
    _check(name, {"x": (x, (rows, d), f32), "t": (t, (rows,), torch.int32),
                  "ck": (ck, (bsz, slots, d), f32),
                  "cv": (cv, (bsz, slots, d), f32),
                  "src_mask": (mask, (bsz, slots), f32),
                  "cache_k": (cache_k, (rows, n_t, d), f32),
                  "cache_v": (cache_v, (rows, n_t, d), f32)}, x.device)
    wptr = _weights(name, wpack, (), d, dff, x.device)
    x_out = torch.empty_like(x)
    q = torch.empty_like(x)
    att = torch.empty_like(x)
    h1 = torch.empty((rows, dff), dtype=f32, device=x.device)
    lib = build.load()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.tfd_layer_step_f32(
        x.data_ptr(), x_out.data_ptr(), t.data_ptr(), ck.data_ptr(),
        cv.data_ptr(), mask.data_ptr(), cache_k.data_ptr(),
        cache_v.data_ptr(), wptr, q.data_ptr(), att.data_ptr(),
        h1.data_ptr(), rows, bsz, slots, d, n_t, dff, n_heads, stream)
    build.check(err, "tfd_layer_step_f32")
    layer_launches += 1
    return x_out, cache_k, cache_v
