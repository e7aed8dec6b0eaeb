"""Additive attention: the wrappers of `csrc/additive_attention.cu`.

Replace the TPU kernels of `unpaired_image_captioning_tpu/ops/attention.py`:

- `additive_attention` (`_fused_attention_kernel`): one query per image;
- `additive_attention_beams` (`_fused_attention_beams_kernel`): K beam
  queries per image over its unexpanded memory, read once for every group
  of up to 16 of them (one launch for any K);
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
`step_launches` count kernel launches.
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


def _check(name: str, dev, tensors: dict) -> None:
    """Each tensor f32, on `dev`, of the given shape, contiguous."""
    for key, (t, shape) in tensors.items():
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"{name}: {key} must be f32 on {dev}, got "
                             f"{t.dtype} on {t.device}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def _widths(name: str, **dims) -> None:
    for key, n in dims.items():
        if n % 4:
            raise ValueError(f"{name}: {key}={n} must be a multiple of 4 "
                             "(float4 loads)")


def _attention_fwd(p_att, att_h, alpha, mask, att_emb, beams: bool):
    global launches, beams_launches
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
    _widths(name, A=a, D=d)
    out = torch.empty((b, k, d) if beams else (b, d), dtype=torch.float32,
                      device=p_att.device)
    lib = build.load()
    stream = torch.cuda.current_stream(p_att.device).cuda_stream
    err = lib.additive_attention_f32(
        p_att.data_ptr(), att_h.data_ptr(), alpha.data_ptr(), mask.data_ptr(),
        att_emb.data_ptr(), out.data_ptr(), b, n, a, d, k, k * d, stream)
    build.check(err, "additive_attention_f32")
    if beams:
        beams_launches += 1
    else:
        launches += 1
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
    global step_launches
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
    _widths("fused_att_lstm_att", A=a, D=d, H=h)
    dev = p_att.device
    h1 = torch.empty((b, h), dtype=torch.float32, device=dev)
    c1 = torch.empty_like(h1)
    att2 = torch.empty((b, d), dtype=torch.float32, device=dev)
    ws = torch.empty((b * (2 * h + d + a),), dtype=torch.float32, device=dev)
    ptrs = (ctypes.c_void_p * len(args))(*[t.data_ptr() for t in args])
    lib = build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.att_lstm_att_f32(ptrs, h1.data_ptr(), c1.data_ptr(),
                               att2.data_ptr(), ws.data_ptr(), b, n, a, d, h,
                               stream)
    build.check(err, "att_lstm_att_f32")
    step_launches += 1
    return h1, c1, att2
