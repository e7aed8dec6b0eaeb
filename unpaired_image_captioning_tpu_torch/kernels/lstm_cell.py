"""Fused LSTM cell: the wrapper of `csrc/lstm_cell.cu` and its plain version.

Replaces the TPU kernel `unpaired_image_captioning_tpu/ops/rnn.py
::_fused_cell_kernel`. One step:

    gates = [x | h] @ w + b                 w [D+H, G*H], b [G*H]
    i, f, o = sigmoid(gates[:3H]);  g = tanh (G=4) or max(m1, m2) (G=5)
    c' = f * c + i * g;  h' = o * tanh(c')

`lstm_cell` is differentiable as the JAX package's custom VJP
(`_make_fused_cell_vjp`) is: the forward is the kernel for CUDA tensors and
the plain version for CPU tensors, and the backward re-runs the plain
version on the saved (w, b, x, h, c) and differentiates it, recomputing the
gates. There is no backward kernel, on the TPU or here. Without a gradient
to take (inference mode, or no input that requires one) the forward runs
alone, with no autograd node. It never routes a CUDA tensor to the plain
version. `launches` counts kernel launches, `bf16_launches` those of them
with a bf16 operand.

Types (the compute dtype, ROADMAP A15). x, (w, b) and (h, c) are each f32
or bf16, in any mixture: the TPU kernel reads each operand in its own type,
accumulates the gates and runs the epilogue in f32, and stores h' and c' in
h's and c's types. The plain version pins those cast points
(`cat([x, h]).float() @ w.float() + b.float()`, `c.float()`, outputs
`.to(h.dtype)` / `.to(c.dtype)`), so in bf16 the gates are never rounded;
the kernel converts each bf16 operand as it loads it (`csrc/bf16.cuh`).
The routes give (x, w, h) = (f32, f32, f32) in f32, (f32 or bf16, f32,
bf16) with bf16 features and f32 weights (serving, eval, the JAX CPU
route), and (bf16, bf16, bf16) on the cast training route. A w and b, or an
h and c, of two types, or any other type, raise, naming the mixture; a CUDA
tensor is never converted to reach another entry. The backward is the plain
recompute in the operands' types, as JAX's VJP of `lstm_step_ref` is.

The kernel splits the reduction over D+H across a thread-block cluster at
small batches; `plan` reports the tile width and cluster size it picks for
a shape.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.autograd import plain_vjp
from . import build

launches = 0
bf16_launches = 0


def lstm_elementwise(gates: torch.Tensor, c: torch.Tensor, hidden_size: int,
                     maxout: bool):
    """Gate epilogue on pre-activations [..., G*H]; gate order (i, f, o, g)
    or (i, f, o, m1, m2)."""
    h_ = hidden_size
    sig = torch.sigmoid(gates[..., : 3 * h_])
    i_g = sig[..., :h_]
    f_g = sig[..., h_: 2 * h_]
    o_g = sig[..., 2 * h_: 3 * h_]
    if maxout:
        in_t = torch.maximum(gates[..., 3 * h_: 4 * h_],
                             gates[..., 4 * h_: 5 * h_])
    else:
        in_t = torch.tanh(gates[..., 3 * h_: 4 * h_])
    c_new = f_g * c + i_g * in_t
    h_new = o_g * torch.tanh(c_new)
    return h_new, c_new


def lstm_cell_plain(w, b, x, h, c, *, maxout: bool):
    """Plain PyTorch version of the kernel. x [B, D]; h, c [B, H]. The gates
    and the epilogue in f32 whatever the operands' types (f32 products of
    bf16 operands are exact), h' and c' in h's and c's types."""
    gates = torch.cat([x, h], dim=-1).float() @ w.float() + b.float()
    h_new, c_new = lstm_elementwise(gates, c.float(), h.shape[-1], maxout)
    return h_new.to(h.dtype), c_new.to(c.dtype)


_TYPES = (torch.float32, torch.bfloat16)


def mixture(x, w, b, h, c) -> int:
    """The kernel's `types` bits for the operands' dtypes (bit 0 x, 1 w and
    b, 2 h and c bf16); raises, naming the mixture, on any the kernel does
    not take."""
    if (x.dtype not in _TYPES or w.dtype not in _TYPES or b.dtype != w.dtype
            or h.dtype not in _TYPES or c.dtype != h.dtype):
        raise ValueError(
            "lstm_cell: no kernel entry for the mixture x "
            f"{x.dtype}, w {w.dtype}, b {b.dtype}, h {h.dtype}, c {c.dtype}: "
            "each of x, (w, b) and (h, c) is float32 or bfloat16, w with b "
            "and h with c of one type")
    return (int(x.dtype == torch.bfloat16) | int(w.dtype == torch.bfloat16) << 1
            | int(h.dtype == torch.bfloat16) << 2)


def plan(batch: int, d: int, hidden: int) -> dict:
    """The kernel's launch for a shape: the tile width `bn` (hidden units a
    block), the cluster size, the rows of K a block of the cluster reduces
    and the blocks of the grid."""
    out = (ctypes.c_int * 4)()
    build.load().lstm_cell_f32_plan(batch, d, hidden, out)
    return dict(zip(("bn", "cluster", "k_rows", "blocks"), out))


def _forward(w, b, x, h, c, maxout: bool):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    global launches, bf16_launches
    if x.device.type == "cpu":
        return lstm_cell_plain(w, b, x, h, c, maxout=maxout)
    if x.device.type != "cuda":
        raise ValueError(f"lstm_cell: unsupported device {x.device}")
    batch, d = x.shape
    hidden = h.shape[-1]
    g = 5 if maxout else 4
    expect = {"w": (d + hidden, g * hidden), "b": (g * hidden,),
              "x": (batch, d), "h": (batch, hidden), "c": (batch, hidden)}
    types = mixture(x, w, b, h, c)
    for name, t in (("w", w), ("b", b), ("x", x), ("h", h), ("c", c)):
        if t.device != x.device:
            raise ValueError(f"lstm_cell: {name} must be on {x.device}, got "
                             f"{t.device}")
        if tuple(t.shape) != expect[name]:
            raise ValueError(f"lstm_cell: {name} has shape {tuple(t.shape)}, "
                             f"expected {expect[name]}")
        if not t.is_contiguous():
            raise ValueError(f"lstm_cell: {name} must be contiguous")
    h_out = torch.empty_like(h)
    c_out = torch.empty_like(c)
    lib = build.load()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.lstm_cell_mixed(x.data_ptr(), h.data_ptr(), c.data_ptr(),
                              w.data_ptr(), b.data_ptr(), h_out.data_ptr(),
                              c_out.data_ptr(), batch, d, hidden, g, types,
                              stream)
    build.check(err, "lstm_cell_mixed")
    launches += 1
    bf16_launches += types != 0
    return h_out, c_out


class _LSTMCell(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, b, x, h, c, maxout):
        ctx.save_for_backward(w, b, x, h, c)
        ctx.maxout = maxout
        return _forward(w, b, x, h, c, maxout)

    @staticmethod
    def backward(ctx, gh, gc):
        def plain(*args):
            return lstm_cell_plain(*args, maxout=ctx.maxout)

        return plain_vjp(plain, ctx.saved_tensors, ctx.needs_input_grad[:5],
                         (gh, gc)) + (None,)


def lstm_cell(w, b, x, h, c, *, maxout: bool):
    """One fused LSTM step; returns (h', c'), each [B, H] in h's type,
    differentiable in w, b, x, h and c."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (w, b, x, h, c)):
        return _LSTMCell.apply(w, b, x, h, c, maxout)
    return _forward(w, b, x, h, c, maxout)
