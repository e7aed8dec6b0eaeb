"""Timestep-blocked LSTM chain, plain PyTorch (counterpart of
`unpaired_image_captioning_tpu/ops/lstm_block.py`).

The chain runs T LSTM steps over hoisted input contributions, time-major:

    gates_t = x_contrib[t] + h_{t-1} @ w_h2h        x_contrib [T, B, G*H]
    (h_t, c_t) = the cell epilogue of gates_t        w_h2h [H, G*H]

with gate order (i, f, o, g) for G = 4 or (i, f, o, m1, m2) for G = 5
(maxout). `chain_fwd_plain` is that step loop and also returns the gates,
which the backward reads. `chain_bwd_plain` is the Pallas `_chain_bwd_kernel`
written out (`lstm_block.py:128-164`): the reverse dh / dc recurrence that
emits dgates (= dx_contrib), dh0 and dc0. Its maxout derivative sends a tie
m1 == m2 wholly to m1, as the JAX package's does; autograd of
`torch.maximum` would split it in half. The CUDA kernels and the
differentiable `blocked_lstm_chain` are in `kernels/lstm_block.py`.

Types (ROADMAP A15), the TPU kernels' cast points: x_contrib, the gates
and dgates are f32; the carry (h0, c0, hs, cs and their cotangents) and
w_h2h may be bf16. The forward adds `h @ w_h2h` in f32 to the f32
x_contrib, runs the cell in f32 on the carry's c, and keeps each step's h
and c in the carry's type (the next step reads them rounded); the backward
computes dgates in f32 from the carry's values, rounds them to w_h2h's type
before `@ w_h2h.t()`, carries dh and dc in f32 and returns dh0 and dc0 in
the carry's types.
"""

from __future__ import annotations

import torch

from ..kernels.lstm_cell import lstm_elementwise


def chain_fwd_plain(x_contrib, h0, c0, w_h2h, *, maxout: bool):
    """(hs, cs [T, B, H], gates [T, B, G*H])."""
    hidden = h0.shape[-1]
    h, c = h0, c0
    hs, cs, gates = [], [], []
    for t in range(x_contrib.shape[0]):
        g = x_contrib[t].float() + h.float() @ w_h2h.float()
        h, c = lstm_elementwise(g, c.float(), hidden, maxout)
        h, c = h.to(h0.dtype), c.to(c0.dtype)
        hs.append(h)
        cs.append(c)
        gates.append(g)
    return torch.stack(hs), torch.stack(cs), torch.stack(gates)


def chain_bwd_plain(gates, cs, c0, dhs, dcs, w_h2h, *, maxout: bool):
    """(dgates [T, B, G*H], dh0 [B, H], dc0 [B, H]) for the cotangents dhs,
    dcs [T, B, H] of the forward's hs and cs."""
    h_ = cs.shape[-1]
    dh = torch.zeros_like(c0, dtype=torch.float32)
    dc = torch.zeros_like(c0, dtype=torch.float32)
    dgates = []
    for t in range(gates.shape[0] - 1, -1, -1):
        g = gates[t]
        sig = torch.sigmoid(g[:, : 3 * h_])
        i_g = sig[:, :h_]
        f_g = sig[:, h_: 2 * h_]
        o_g = sig[:, 2 * h_: 3 * h_]
        if maxout:
            m1 = g[:, 3 * h_: 4 * h_]
            m2 = g[:, 4 * h_: 5 * h_]
            in_t = torch.maximum(m1, m2)
        else:
            in_t = torch.tanh(g[:, 3 * h_: 4 * h_])
        c_prev = (cs[t - 1] if t > 0 else c0).float()
        th = torch.tanh(cs[t].float())
        dh = dhs[t].float() + dh
        do = dh * th
        dct = dh * o_g * (1.0 - th * th) + dc + dcs[t].float()
        dgi = dct * in_t * i_g * (1.0 - i_g)
        dgf = dct * c_prev * f_g * (1.0 - f_g)
        dgo = do * o_g * (1.0 - o_g)
        dm = dct * i_g
        if maxout:
            pick = (m1 >= m2).to(dm.dtype)
            dtail = torch.cat([dm * pick, dm * (1.0 - pick)], dim=-1)
        else:
            dtail = dm * (1.0 - in_t * in_t)
        dg = torch.cat([dgi, dgf, dgo, dtail], dim=-1)
        dgates.append(dg)
        dh = dg.to(w_h2h.dtype).float() @ w_h2h.float().t()
        dc = dct * f_g
    return torch.stack(dgates[::-1]), dh.to(c0.dtype), dc.to(c0.dtype)
