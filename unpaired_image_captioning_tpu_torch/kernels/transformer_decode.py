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
`layer_launches` count kernel launches, `bf16_stack_launches` and
`bf16_layer_launches` those of them with a bf16 operand, and
`tc_stack_launches` and `tc_layer_launches` those whose products ran on
the tensor cores. `route` states which instances a step takes; the C
entry points report the route they ran, and a wrapper raises where it
differs from the rule.

Types (the compute dtype, ROADMAP A15): x (the step's compute type), the
packed weights (all of one type), the caches (k and v of one type) and the
memory's K / V (of one type) are each f32 or bf16, so every mixture runs:
the routes give all f32, f32 x and weights over bf16 caches and memory
(the card's serving and `eval_split` of rounded features) and all bf16
(the SCST sample under `bf16_params`). `MIXTURES` lists them. x_out is in
x's type; the kernel's q / att / h1 scratch is f32, or bf16 on the
tensor-core route (allocated at f32 size either way). Any other type
raises, naming the mixture.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.transformer_decode import (WKEYS, decoder_layer_step_plain,
                                      decoder_stack_step_plain, src_mask_2d)
from . import build

stack_launches = 0
layer_launches = 0
bf16_stack_launches = 0
bf16_layer_launches = 0
tc_stack_launches = 0
tc_layer_launches = 0

_TYPES = (torch.float32, torch.bfloat16)
# the kernel's type flags (csrc/transformer_decode.cu: TFD_*)
X_BF, W_BF, C_BF, M_BF = 1, 2, 4, 8
# (x, weights, caches, memory) of the routes: f32; serving and eval of
# bf16 features (the memory's type reaches the caches); the cast route
MIXTURES = (("f32", "f32", "f32", "f32"), ("f32", "f32", "bf16", "bf16"),
            ("bf16", "bf16", "bf16", "bf16"))


def mixture(name: str, x, w: dict, cache_k, cache_v, ck, cv) -> int:
    """The kernel's TFD_* flags for the operands' types; raises, naming the
    mixture, on one the kernel does not take."""
    wt = {w[k].dtype for k in WKEYS}
    if (x.dtype not in _TYPES or len(wt) != 1 or not wt <= set(_TYPES)
            or cache_k.dtype not in _TYPES or cache_v.dtype != cache_k.dtype
            or ck.dtype not in _TYPES or cv.dtype != ck.dtype):
        raise ValueError(
            f"{name}: no kernel entry for the mixture x {x.dtype}, weights "
            f"{sorted(map(str, wt))}, caches {cache_k.dtype} / "
            f"{cache_v.dtype}, memory {ck.dtype} / {cv.dtype}: each of x, "
            "the weights (all of one type), the caches and the memory "
            "float32 or bfloat16")
    bf = torch.bfloat16
    return (X_BF * (x.dtype == bf) | W_BF * (wt == {bf})
            | C_BF * (cache_k.dtype == bf) | M_BF * (ck.dtype == bf))


# the route bits the C entry points report (csrc/transformer_decode.cu:
# TFD_ROUTE_*): the products on the tensor cores, the self-attention and
# the cross-attention on their fast kernels
ROUTE_TC, ROUTE_SELF, ROUTE_CROSS = 1, 2, 4
# what the kernels' shared memory holds (csrc/transformer_decode.cu)
_MAX_SMEM = 227 * 1024           # bytes a block can opt into
_SELF_WARP_FLOATS = _MAX_SMEM // 4 // 8   # a warp of an 8-warp block
_CROSS_MAX_CLUSTER, _CROSS_SLICE = 8, 64


def _round(n: int, m: int) -> int:
    return -(-n // m) * m


def _cross_bytes(kq: int, dh: int, chunk: int, cs: int, mbf: bool) -> int:
    """Shared memory of a fast cross-attention block (`cross_smem`): Q f32
    [kq][dh + 4], K [chunk][dh + 4] f32 or [chunk][dh + 8] bf16, V
    [chunk][dh] in the memory's type, P f32 [kq][chunk], and the cs
    partials rank 0 receives, each region on 16 bytes."""
    es, ldk = (2, dh + 8) if mbf else (4, dh + 4)
    k = _round(kq * (dh + 4) * 4, 16)
    v = k + _round(chunk * ldk * es, 16)
    p = v + _round(chunk * dh * es, 16)
    part = _round(2 * kq, 4) + kq * dh + _round(kq * chunk, 4)
    return p + _round(kq * chunk, 4) * 4 + cs * part * 4


def route(fl: int, d: int, dff: int, n_heads: int, n_t: int,
          slots: int) -> int:
    """The routing rule of a step of type flags `fl` (`mixture`), d in
    n_heads heads, d_ff, a cache of n_t slots and `slots` memory slots; the
    C side (`route_of`) takes the same decisions:

    - ROUTE_SELF: the self-attention's fast kernel (a warp per row and
      head, loads of 4 or 8 elements) where the head width is a multiple
      of 4 and the head's query, scores and rows of n_t positions fit a
      warp's share of shared memory;
    - ROUTE_CROSS: the cluster flash-decoding cross-attention where the
      head width is a multiple of 4 and one query beside a slice of K and V
      (in the memory's type: bf16 halves them) fits a block (the beams of
      an image then go in the fewest query groups that fit);
    - ROUTE_TC: the products on the tensor cores where x and the weights
      are bf16, d and d_ff multiples of 8, and both attentions fast (the
      scratch between the kernels is then bf16, which only the fast
      attentions read).

    Every mixture takes the fast attentions on the same shapes; the rest
    run their scalar kernels, and products with an f32 operand the f32
    FMA core."""
    dh = d // n_heads
    r = 0
    if dh % 4 == 0 and _round(dh, 4) + 2 * _round(n_t, 4) \
            <= _SELF_WARP_FLOATS:
        r |= ROUTE_SELF
    if dh % 4 == 0:
        cs = 1
        while cs < _CROSS_MAX_CLUSTER and cs * _CROSS_SLICE < slots:
            cs *= 2
        if _cross_bytes(1, dh, -(-slots // cs), cs, bool(fl & M_BF)) \
                <= _MAX_SMEM:
            r |= ROUTE_CROSS
    if (fl & X_BF and fl & W_BF and d % 8 == 0 and dff % 8 == 0
            and r == ROUTE_SELF | ROUTE_CROSS):
        r |= ROUTE_TC
    return r


def _ran(name: str, got: int, fl: int, d: int, dff: int, n_heads: int,
         n_t: int, slots: int) -> int:
    """The route the C call reported, held against `route`."""
    want = route(fl, d, dff, n_heads, n_t, slots)
    if got != want:
        raise RuntimeError(f"{name}: the kernel ran route {got}, the rule "
                           f"names {want} (types {fl}, d {d}, d_ff {dff}, "
                           f"{n_heads} heads, T {n_t}, S {slots})")
    return got


def _check(name: str, tensors: dict, device) -> None:
    for key, (t, shape, dtype) in tensors.items():
        dtype = t.dtype if dtype is None else dtype
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
                             "boundary (the kernel loads float4 rows where "
                             "the widths allow)")


def _check_dims(name: str, rows: int, bsz: int, d: int, dff: int,
                n_heads: int, slots: int, n_t: int) -> None:
    """Raise for a shape the kernels do not take: rows that are not whole
    beams of the images, or d not split into the heads (as the JAX
    package's head split). Any width, cache and slot count runs, so d_ff,
    the slots and the cache length decide nothing; they stay in the
    signature that `chip_smoke.py --times tfd` calls on any tree."""
    if bsz <= 0 or rows % bsz:
        raise ValueError(f"{name}: {rows} rows are not a whole number of "
                         f"beams over {bsz} images")
    if n_heads <= 0 or d % n_heads:
        raise ValueError(f"{name}: d={d} does not split into {n_heads} "
                         "heads")


def _weights(name: str, w: dict, lead: tuple, d: int, dff: int, device):
    shapes = {"wqkv": (d, 3 * d), "bqkv": (3 * d,), "wo_s": (d, d),
              "wq_c": (d, d), "wo_c": (d, d), "w1": (d, dff), "b1": (dff,),
              "w2": (dff, d)}
    _check(name, {k: (w[k], lead + shapes.get(k, (d,)), None)
                  for k in WKEYS}, device)
    return (ctypes.c_void_p * len(WKEYS))(*[w[k].data_ptr() for k in WKEYS])


def decoder_stack_step(x, t, ck_all, cv_all, src_mask, cache_k, cache_v,
                       wstack, anc=None, *, n_heads: int,
                       want_attn: bool = False):
    """All L decoder layers for one decode step; see
    `ops.transformer_decode.decoder_stack_step_plain` for the arguments.
    On CUDA: x, ck_all, cv_all, cache_k, cache_v and the weights f32 or bf16
    (`mixture`), t and anc int32, all contiguous; the caches are written in
    place."""
    global stack_launches, bf16_stack_launches, tc_stack_launches
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
    fl = mixture(name, x, wstack, cache_k, cache_v, ck_all, cv_all)
    f32, i32 = torch.float32, torch.int32
    arrays = {"x": (x, (rows, d), None), "t": (t, (rows,), i32),
              "ck_all": (ck_all, (n_layers, bsz, slots, d), None),
              "cv_all": (cv_all, (n_layers, bsz, slots, d), None),
              "src_mask": (mask, (bsz, slots), f32),
              "cache_k": (cache_k, (rows, n_layers, n_t, d), None),
              "cache_v": (cache_v, (rows, n_layers, n_t, d), None)}
    if anc is not None:
        arrays["anc"] = (anc, (rows, n_t), i32)
    _check(name, arrays, x.device)
    wptr = _weights(name, wstack, (n_layers,), d, dff, x.device)
    x_out = torch.empty_like(x)
    q = torch.empty((rows, d), dtype=f32, device=x.device)
    att = torch.empty_like(q)
    h1 = torch.empty((rows, dff), dtype=f32, device=x.device)
    attn_h = attn = None
    if want_attn:
        attn_h = torch.empty((rows, n_heads, slots + 2), dtype=f32,
                             device=x.device)
        attn = torch.empty((rows, slots), dtype=f32, device=x.device)
    lib = build.load()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ran = ctypes.c_int(-1)
    err = lib.tfd_stack_step_mixed(
        x.data_ptr(), x_out.data_ptr(), t.data_ptr(), ck_all.data_ptr(),
        cv_all.data_ptr(), mask.data_ptr(), cache_k.data_ptr(),
        cache_v.data_ptr(), None if anc is None else anc.data_ptr(), wptr,
        q.data_ptr(), att.data_ptr(), h1.data_ptr(),
        None if attn_h is None else attn_h.data_ptr(),
        None if attn is None else attn.data_ptr(),
        rows, bsz, slots, d, n_t, dff, n_heads, n_layers, fl,
        ctypes.addressof(ran), stream)
    build.check(err, "tfd_stack_step_mixed")
    got = _ran(name, ran.value, fl, d, dff, n_heads, n_t, slots)
    stack_launches += 1
    bf16_stack_launches += fl != 0
    tc_stack_launches += bool(got & ROUTE_TC)
    if want_attn:
        return x_out, cache_k, cache_v, attn
    return x_out, cache_k, cache_v


def decoder_layer_step(x, t, ck, cv, src_mask, cache_k, cache_v, wpack, *,
                       n_heads: int):
    """One decoder layer for one decode step; see
    `ops.transformer_decode.decoder_layer_step_plain` for the arguments.
    On CUDA the tensors are as for `decoder_stack_step`, without the layer
    axis; the caches are written in place."""
    global layer_launches, bf16_layer_launches, tc_layer_launches
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
    fl = mixture(name, x, wpack, cache_k, cache_v, ck, cv)
    f32 = torch.float32
    _check(name, {"x": (x, (rows, d), None), "t": (t, (rows,), torch.int32),
                  "ck": (ck, (bsz, slots, d), None),
                  "cv": (cv, (bsz, slots, d), None),
                  "src_mask": (mask, (bsz, slots), f32),
                  "cache_k": (cache_k, (rows, n_t, d), None),
                  "cache_v": (cache_v, (rows, n_t, d), None)}, x.device)
    wptr = _weights(name, wpack, (), d, dff, x.device)
    x_out = torch.empty_like(x)
    q = torch.empty((rows, d), dtype=f32, device=x.device)
    att = torch.empty_like(q)
    h1 = torch.empty((rows, dff), dtype=f32, device=x.device)
    lib = build.load()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ran = ctypes.c_int(-1)
    err = lib.tfd_layer_step_mixed(
        x.data_ptr(), x_out.data_ptr(), t.data_ptr(), ck.data_ptr(),
        cv.data_ptr(), mask.data_ptr(), cache_k.data_ptr(),
        cache_v.data_ptr(), wptr, q.data_ptr(), att.data_ptr(),
        h1.data_ptr(), rows, bsz, slots, d, n_t, dff, n_heads, fl,
        ctypes.addressof(ran), stream)
    build.check(err, "tfd_layer_step_mixed")
    got = _ran(name, ran.value, fl, d, dff, n_heads, n_t, slots)
    layer_launches += 1
    bf16_layer_launches += fl != 0
    tc_layer_launches += bool(got & ROUTE_TC)
    return x_out, cache_k, cache_v
