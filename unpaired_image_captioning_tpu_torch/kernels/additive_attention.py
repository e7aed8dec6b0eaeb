"""Additive attention: the wrappers of `csrc/additive_attention.cu`.

Replace the TPU kernels of `unpaired_image_captioning_tpu/ops/attention.py`:

- `additive_attention` (`_fused_attention_kernel`): one query per image;
- `additive_attention_beams` (`_fused_attention_beams_kernel`): K beam
  queries per image over its unexpanded memory, read once for every group
  of up to 8 of them (one launch for any K; each image's slots split
  across a thread-block cluster);
- `fused_att_lstm_att` (`_att_lstm_att_kernel`): att1, the maxout lstm1
  and att2 of a StackAtt / DenseAtt decode step.

The plain versions and the semantics (no alpha_net bias, softmax then mask
then renormalise) are in `ops/attention.py`. Each wrapper runs its plain
version for CPU tensors and launches the kernel for CUDA tensors; it never
routes a CUDA tensor to the plain version. The first two are
differentiable as the JAX custom VJPs are: the backward differentiates the
plain version, recomputed from the saved inputs. `fused_att_lstm_att` has
no gradient (the JAX function is jit only): it raises when an input
requires one while grad mode is on. `launches`, `beams_launches` and
`step_launches` count kernel launches; `bf16_launches`,
`beams_bf16_launches` and `step_bf16_launches` those of them with a bf16
operand, `step_bf16w_launches` the decode steps whose two products read a
bf16 copy of their weights (decode_gemm's converting loads). Any widths A,
D and H are taken (float4 loads where they are multiples of 4, scalar ones
otherwise).

Types (ROADMAP A15): every operand may be f32 or bf16, as the TPU kernels
read each in its own type and compute in f32; the attentions' outputs take
att_emb's type, the decode step's h1 / c1 the carry's and att2 att_emb's.
The kernels convert as they read (`csrc/bf16.cuh`). Within the decode step
h1_prev and c1_prev, w1 and b1, the four product tensors, and alpha1 and
alpha2 are each of one type; any other mixture, or another type, raises
naming it. A CUDA tensor is never converted to reach another entry.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.attention import (att_lstm_att_plain, reference_attention,
                             reference_attention_beams)
from ..ops.autograd import plain_vjp
from . import build

launches = 0          # additive_attention
beams_launches = 0    # additive_attention_beams
step_launches = 0     # fused_att_lstm_att
bf16_launches = 0          # of those, with a bf16 operand
beams_bf16_launches = 0
step_bf16_launches = 0
step_bf16w_launches = 0    # decode steps with bf16 product weights

_TYPES = (torch.float32, torch.bfloat16)


def plan(b: int, n: int, a: int, d: int, k: int) -> dict:
    """The kernel's launch plan for a shape (16-byte rows): the cluster
    size, the queries a group, the groups and a block's shared memory in
    bytes."""
    out = (ctypes.c_int * 4)()
    build.check(build.load().additive_attention_plan(b, n, a, d, k, out),
                "additive_attention_plan")
    return dict(cluster=out[0], group=out[1], groups=out[2], smem=out[3])


def _types(name: str, groups) -> int:
    """The kernel's `types` bits: bit i set where group i is bf16. Each group
    is a tuple of (key, tensor) of one type, f32 or bf16; raises, naming the
    mixture, otherwise."""
    bits = 0
    for i, group in enumerate(groups):
        kinds = {t.dtype for _, t in group}
        if len(kinds) != 1 or not kinds <= set(_TYPES):
            mix = ", ".join(f"{k} {t.dtype}" for g in groups for k, t in g)
            raise ValueError(
                f"{name}: no kernel entry for the mixture {mix}: "
                + " / ".join("(" + ", ".join(k for k, _ in g) + ")"
                             for g in groups if len(g) > 1)
                + " each of one type, every operand float32 or bfloat16")
        bits |= int(kinds == {torch.bfloat16}) << i
    return bits


def _check(name: str, dev, tensors: dict) -> None:
    """Each tensor on `dev`, of the given shape, contiguous."""
    for key, (t, shape) in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name}: {key} must be on {dev}, got "
                             f"{t.device}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def _attention_fwd(p_att, att_h, alpha, mask, att_emb, beams: bool):
    global launches, beams_launches, bf16_launches, beams_bf16_launches
    name = "additive_attention_beams" if beams else "additive_attention"
    if p_att.device.type == "cpu":
        plain = reference_attention_beams if beams else reference_attention
        return plain(p_att, att_h, alpha, mask, att_emb)
    if p_att.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {p_att.device}")
    b, n, a = p_att.shape
    d = att_emb.shape[-1]
    k = att_h.shape[1] if beams else 1
    _check(name, p_att.device, {
        "p_att": (p_att, (b, n, a)),
        "att_h": (att_h, (b, k, a) if beams else (b, a)),
        "alpha": (alpha, (a, 1)), "mask": (mask, (b, n)),
        "att_emb": (att_emb, (b, n, d))})
    types = _types(name, [(("p_att", p_att),), (("att_h", att_h),),
                          (("alpha", alpha),), (("mask", mask),),
                          (("att_emb", att_emb),)])
    types |= (types >> 4 & 1) << 5        # the output in att_emb's type
    out = torch.empty((b, k, d) if beams else (b, d), dtype=att_emb.dtype,
                      device=p_att.device)
    lib = build.load()
    stream = torch.cuda.current_stream(p_att.device).cuda_stream
    err = lib.additive_attention_mixed(
        p_att.data_ptr(), att_h.data_ptr(), alpha.data_ptr(), mask.data_ptr(),
        att_emb.data_ptr(), out.data_ptr(), b, n, a, d, k, k * d, types,
        stream)
    build.check(err, "additive_attention_mixed")
    if beams:
        beams_launches += 1
        beams_bf16_launches += types != 0
    else:
        launches += 1
        bf16_launches += types != 0
    return out


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, p_att, att_h, alpha, mask, att_emb, beams):
        ctx.save_for_backward(p_att, att_h, alpha, mask, att_emb)
        ctx.beams = beams
        return _attention_fwd(p_att, att_h, alpha, mask, att_emb, beams)

    @staticmethod
    def backward(ctx, g):
        plain = reference_attention_beams if ctx.beams else reference_attention
        return plain_vjp(plain, ctx.saved_tensors, ctx.needs_input_grad[:5],
                         (g,)) + (None,)


def _attention(p_att, att_h, alpha, mask, att_emb, beams: bool):
    args = (p_att, att_h, alpha, mask, att_emb)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _Attention.apply(*args, beams)
    return _attention_fwd(*args, beams)


def additive_attention(p_att, att_h, alpha, mask, att_emb):
    """p_att [B, N, A], att_h [B, A], alpha [A, 1] (the alpha_net weight),
    mask [B, N] (ones where the model has none), att_emb [B, N, D] ->
    [B, D]. Differentiable in every input."""
    return _attention(p_att, att_h, alpha, mask, att_emb, beams=False)


def additive_attention_beams(p_att, att_h, alpha, mask, att_emb):
    """The K-beam form: att_h [B, K, A] -> [B, K, D]; the memory of image b
    serves its K queries. Differentiable in every input."""
    return _attention(p_att, att_h, alpha, mask, att_emb, beams=True)


def fused_att_lstm_att(p_att, att_emb, mask, q1, h0d, h1_prev, c1_prev, w1,
                       b1, emb2_w, emb2_b, h2att2_w, h2att2_b, alpha1,
                       alpha2):
    """The decode step between lstm0 and lstm2 (see
    `ops.attention.att_lstm_att_plain`); returns (h1, c1, att2). Raises
    when an input requires a gradient while grad mode is on: it has no
    backward and must not return a tensor cut off from the graph."""
    global step_launches, step_bf16_launches, step_bf16w_launches
    args = (p_att, att_emb, mask, q1, h0d, h1_prev, c1_prev, w1, b1, emb2_w,
            emb2_b, h2att2_w, h2att2_b, alpha1, alpha2)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        raise RuntimeError("fused_att_lstm_att has no gradient (decode "
                           "only): run it under torch.no_grad() or "
                           "torch.inference_mode(), or turn STEP_FUSION off")
    if p_att.device.type == "cpu":
        return att_lstm_att_plain(*args)
    if p_att.device.type != "cuda":
        raise ValueError(f"fused_att_lstm_att: unsupported device "
                         f"{p_att.device}")
    b, n, a = p_att.shape
    d = att_emb.shape[-1]
    h = h1_prev.shape[-1]
    h0 = h0d.shape[-1]
    if h0 != h:
        raise ValueError(f"fused_att_lstm_att: h0d width {h0} != hidden {h}")
    _check("fused_att_lstm_att", p_att.device, {
        "p_att": (p_att, (b, n, a)), "att_emb": (att_emb, (b, n, d)),
        "mask": (mask, (b, n)), "q1": (q1, (b, a)), "h0d": (h0d, (b, h)),
        "h1_prev": (h1_prev, (b, h)), "c1_prev": (c1_prev, (b, h)),
        "w1": (w1, (2 * h + d, 5 * h)), "b1": (b1, (5 * h,)),
        "emb2_w": (emb2_w, (d, h)), "emb2_b": (emb2_b, (h,)),
        "h2att2_w": (h2att2_w, (h, a)), "h2att2_b": (h2att2_b, (a,)),
        "alpha1": (alpha1, (a, 1)), "alpha2": (alpha2, (a, 1))})
    types = _types("fused_att_lstm_att", [
        (("p_att", p_att),), (("att_emb", att_emb),), (("mask", mask),),
        (("q1", q1),), (("h0d", h0d),),
        (("h1_prev", h1_prev), ("c1_prev", c1_prev)),
        (("w1", w1), ("b1", b1)),
        (("emb2_w", emb2_w), ("emb2_b", emb2_b), ("h2att2_w", h2att2_w),
         ("h2att2_b", h2att2_b)),
        (("alpha1", alpha1), ("alpha2", alpha2))])
    dev = p_att.device
    h1 = torch.empty((b, h), dtype=h1_prev.dtype, device=dev)
    c1 = torch.empty_like(h1)
    att2 = torch.empty((b, d), dtype=att_emb.dtype, device=dev)
    ws = torch.empty((b * (4 * h + d + a),), dtype=torch.float32, device=dev)
    ptrs = (ctypes.c_void_p * len(args))(*[t.data_ptr() for t in args])
    lib = build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.att_lstm_att_mixed(ptrs, h1.data_ptr(), c1.data_ptr(),
                                 att2.data_ptr(), ws.data_ptr(), b, n, a, d,
                                 h, types, stream)
    build.check(err, "att_lstm_att_mixed")
    step_launches += 1
    step_bf16_launches += types != 0
    step_bf16w_launches += (types >> 7) & 1
    return h1, c1, att2
