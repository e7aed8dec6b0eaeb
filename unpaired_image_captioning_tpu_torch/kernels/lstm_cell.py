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
version. `launches` counts kernel launches.
"""

from __future__ import annotations

import torch

from ..ops.autograd import plain_vjp
from . import build

launches = 0


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
    """Plain PyTorch version of the kernel. x [B, D]; h, c [B, H]."""
    gates = torch.cat([x, h], dim=-1) @ w + b
    return lstm_elementwise(gates, c, h.shape[-1], maxout)


def _forward(w, b, x, h, c, maxout: bool):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    global launches
    if x.device.type == "cpu":
        return lstm_cell_plain(w, b, x, h, c, maxout=maxout)
    if x.device.type != "cuda":
        raise ValueError(f"lstm_cell: unsupported device {x.device}")
    batch, d = x.shape
    hidden = h.shape[-1]
    g = 5 if maxout else 4
    expect = {"w": (d + hidden, g * hidden), "b": (g * hidden,),
              "x": (batch, d), "h": (batch, hidden), "c": (batch, hidden)}
    for name, t in (("w", w), ("b", b), ("x", x), ("h", h), ("c", c)):
        if t.device != x.device or t.dtype != torch.float32:
            raise ValueError(f"lstm_cell: {name} must be f32 on {x.device}, "
                             f"got {t.dtype} on {t.device}")
        if tuple(t.shape) != expect[name]:
            raise ValueError(f"lstm_cell: {name} has shape {tuple(t.shape)}, "
                             f"expected {expect[name]}")
        if not t.is_contiguous():
            raise ValueError(f"lstm_cell: {name} must be contiguous")
    h_out = torch.empty_like(h)
    c_out = torch.empty_like(c)
    lib = build.load()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.lstm_cell_f32(x.data_ptr(), h.data_ptr(), c.data_ptr(),
                            w.data_ptr(), b.data_ptr(), h_out.data_ptr(),
                            c_out.data_ptr(), batch, d, hidden, g, stream)
    build.check(err, "lstm_cell_f32")
    launches += 1
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
    """One fused LSTM step; returns (h', c'), each [B, H] f32,
    differentiable in w, b, x, h and c."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (w, b, x, h, c)):
        return _LSTMCell.apply(w, b, x, h, c, maxout)
    return _forward(w, b, x, h, c, maxout)
