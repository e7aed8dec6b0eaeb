"""LSTM cells (counterpart of `unpaired_image_captioning_tpu/ops/rnn.py`).

Weights layout (one `LSTMCell` per cell, JAX layout):
    w: f32[D + H, G*H]   (input rows first, then hidden rows)
    b: f32[G*H]
with G = 4 (standard LSTM: i, f, o, g-tanh) or G = 5 (maxout: i, f, o,
m1, m2).

`lstm_step` sends every CUDA step to the fused kernel
(`kernels/lstm_cell.py`) whatever its shape, and every CPU step to the plain
version; the JAX package's alignment gate (TPU tiles) has no counterpart.
Both are differentiable: the backward recomputes the gates with the plain
version, as the JAX custom VJP does.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..kernels.lstm_cell import lstm_cell, lstm_cell_plain


class LSTMCell(nn.Module):
    """Parameters of one fused cell: `w` [D+H, G*H] and `b` [G*H]."""

    def __init__(self, input_size: int, hidden_size: int, *,
                 maxout: bool = False, device=None):
        super().__init__()
        g = 5 if maxout else 4
        self.input_size, self.hidden_size, self.maxout = (
            input_size, hidden_size, maxout)
        self.w = nn.Parameter(torch.empty(
            (input_size + hidden_size, g * hidden_size), device=device))
        self.b = nn.Parameter(torch.empty((g * hidden_size,), device=device))

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """uniform(-1/sqrt(H), 1/sqrt(H)) for w and b, as init_lstm_params."""
        scale = 1.0 / math.sqrt(self.hidden_size)
        for p in (self.w, self.b):
            p.copy_(uniform(p.shape, scale, generator))


def uniform(shape, scale: float, generator: torch.Generator) -> torch.Tensor:
    """uniform(-scale, scale) drawn on the generator's device."""
    return (torch.rand(shape, generator=generator, device=generator.device)
            * 2.0 - 1.0) * scale


def init_lstm_params(input_size: int, hidden_size: int, *,
                     maxout: bool = False, device=None) -> LSTMCell:
    return LSTMCell(input_size, hidden_size, maxout=maxout, device=device)


def lstm_step_ref(params: LSTMCell, x, h, c, *, maxout: bool = False):
    """Plain PyTorch cell. x: [B, D]; h, c: [B, H]."""
    return lstm_cell_plain(params.w, params.b, x, h, c, maxout=maxout)


def lstm_step(params: LSTMCell, x, h, c, *, maxout: bool = False):
    """One LSTM step; returns (h_new, c_new), both [B, H]. CUDA tensors run
    the fused kernel, CPU tensors the plain version."""
    return lstm_cell(params.w, params.b, x.contiguous(), h.contiguous(),
                     c.contiguous(), maxout=maxout)


# ---------------------------------------------------------------------------
# Stacked input-feed cells (NMT decoder)
# ---------------------------------------------------------------------------

def init_stacked_lstm(num_layers: int, input_size: int, hidden_size: int, *,
                      device=None) -> nn.ModuleList:
    return nn.ModuleList(
        init_lstm_params(input_size if layer == 0 else hidden_size,
                         hidden_size, device=device)
        for layer in range(num_layers))


def stacked_lstm_step(params: nn.ModuleList, x, hs, cs, *,
                      generator: torch.Generator | None = None,
                      dropout: float = 0.0):
    """Input-feed stacked LSTM step. hs, cs: [L, B, H]. Dropout between
    layers (not after the last) applies only with a generator (training);
    inference passes none. Returns (top_h, new_hs, new_cs)."""
    num_layers = len(params)
    new_h, new_c = [], []
    inp = x
    for layer in range(num_layers):
        h_i, c_i = lstm_step(params[layer], inp, hs[layer], cs[layer])
        inp = h_i
        if layer + 1 != num_layers and dropout > 0.0 and generator is not None:
            keep = torch.rand(inp.shape, generator=generator,
                              device=inp.device) < 1.0 - dropout
            inp = torch.where(keep, inp / (1.0 - dropout),
                              torch.zeros_like(inp))
        new_h.append(h_i)
        new_c.append(c_i)
    return inp, torch.stack(new_h), torch.stack(new_c)
