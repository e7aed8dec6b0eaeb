"""Whole-layer training transformer layers, plain PyTorch (counterpart of
`unpaired_image_captioning_tpu/ops/layer_train.py`).

The functions of the Pallas `fused_enc_layer` and `fused_dec_layer` and of
their CUDA port (`kernels/layer_train.py`, `csrc/layer_train.cu`), written
out over the whole batch, f32. One pre-norm encoder layer:

    x2  = x + drop1(attn(LN1(x) Wqkv + bqkv; maskadd) Wo + bo)
    out = x2 + drop3(drop2(relu(LN2(x2) W1 + b1)) W2 + b2)

with LN the reference's (unbiased variance, eps 1e-6 outside the sqrt,
`ops/ln_train.py`) and attn the training attention (`ops/mha_train.py`)
over the q | k | v column blocks of the packed projection. The decoder
layer adds a cross sublayer between the two, over the memory's K/V
projections mk / mv (computed outside):

    x3  = x2 + drop1'(attn(LN2(x2) Wq + bq, mk, mv; src mask) Wo2 + bo2)

and its FFN reads LN3(x3). Dropout is the splitmix32 hash of
`ops/mha_train.keep_mask` with 4 sites per batch element b, block id
pid = (b * 4 + site) * H + h: site 0 the attention probabilities (per
head), site 1 the residual after attention, site 2 inside the FFN, site 3
the residual after the FFN (h = 0 for sites 1-3), each over the element's
[T, cols] block with element index row * cols + col. The self-attention and
FFN sites draw under seeds[0]; the decoder's cross sublayer draws sites 0
and 1 under seeds[1].

The backward is the Pallas kernel's: the FFN half (`ffn_bwd_plain`, the
Pallas `_bwd_ffn_kernel`), the cross half (`cross_bwd_plain`,
`_bwd_cross_kernel`) and the attention half (`attn_bwd_plain`,
`_bwd_attn_kernel`), each emitting the full gradient of its input (the
residual included) and its weight gradients summed over the batch. Masked
scores get zero gradient.

Types, the Pallas kernels' cast points with dtype = x's type (f32, or bf16
on the cast route; the weights in their own types): LayerNorm in f32 to
dtype; `_linear` is the f32 product cast to dtype plus the bias cast to
dtype; a forward dropout divides in dtype; the residual sums in dtype; the
attention as `ops/mha_train.py`. The backward's cotangents are f32 and
rounded to dtype where the Pallas kernel casts them (dfc, dlinc, doc, dao,
dq / dk / dv); dx is in x's type and each weight's gradient, summed in f32,
in that weight's type. A bias gradient sums the rounded cotangent its
weight gradient reads, as the CUDA kernel does (the Pallas kernel sums it
unrounded: a 2^-9 relative rounding a row).
"""

from __future__ import annotations

import torch

from .ln_train import ln_bwd_f32, ln_train_plain
from .mha_train import (keep_mask, mha_train_plain, mha_train_plain_bwd,
                        rounded, up)

N_SITES = 4   # dropout sites per (layer, batch element)
EPS = 1e-6

# the order of the weights in every function of the port's layer kernels
ENC_WEIGHTS = ("wqkv", "bqkv", "wo", "bo", "w1", "b1", "w2", "b2",
               "l1s", "l1b", "l2s", "l2b")
DEC_WEIGHTS = ("wqkv", "bqkv", "wo", "bo", "wq", "bq", "wo2", "bo2",
               "w1", "b1", "w2", "b2", "l1s", "l1b", "l2s", "l2b",
               "l3s", "l3b")


def drop_site(x, seed, site: int, n_heads: int, rate: float):
    """keep ? x / (1 - rate) : 0 over x [B, T, C] at residual or FFN site
    `site` (h = 0); x itself at rate 0. As the Pallas `_drop` computes it in
    x's type: a bf16 x is divided in bf16 by the weakly typed 1 - rate (in
    bf16 too); an f32 x in f32 (the backward's f32 cotangents)."""
    if rate <= 0.0:
        return x
    b, t, c = x.shape
    keep = keep_mask(seed, b, n_heads, t, c, rate, n_sites=N_SITES,
                     site=site, heads=1)[:, 0]
    div = (torch.tensor(1.0 - rate, dtype=x.dtype)
           if x.dtype == torch.bfloat16 else 1.0 - rate)
    return torch.where(keep, x / div, torch.zeros((), dtype=x.dtype))


def _rows(x):
    return x.reshape(-1, x.shape[-1])


def _wgrad(a, g):
    """sum over the batch of a^T g: [B, T, m] x [B, T, n] -> [m, n], f32."""
    return up(_rows(a)).T @ up(_rows(g))


def _lin(a, w, b, dt):
    """The Pallas `_linear`: the f32 product of the values, cast to dt, plus
    the bias cast to dt (in dt)."""
    return (up(a) @ up(w)).to(dt) + b.to(dt)


def _attention(q, k, v, maskadd, seed, n_heads, rate):
    return mha_train_plain(q, k, v, maskadd, seed, n_heads=n_heads,
                           rate=rate, n_sites=N_SITES)


def _self_fwd(x, maskadd, seed, wqkv, bqkv, wo, bo, ls, lb, n_heads, rate):
    d, dt = x.shape[-1], x.dtype
    qkv = _lin(ln_train_plain(x, ls, lb, EPS), wqkv, bqkv, dt)
    ao = _attention(qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:],
                    maskadd, seed, n_heads, rate)
    return x + drop_site(_lin(ao, wo, bo, dt), seed, 1, n_heads, rate)


def _ffn_fwd(x, seed, w1, b1, w2, b2, ls, lb, n_heads, rate):
    dt = x.dtype
    h = torch.relu(_lin(ln_train_plain(x, ls, lb, EPS), w1, b1, dt))
    hd = drop_site(h, seed, 2, n_heads, rate)
    return x + drop_site(_lin(hd, w2, b2, dt), seed, 3, n_heads, rate)


def enc_fwd_plain(x, maskadd, seed, wqkv, bqkv, wo, bo, w1, b1, w2, b2,
                  l1s, l1b, l2s, l2b, *, n_heads: int, rate: float):
    """(out, x2): the Pallas `_fwd_kernel`. x [B, T, d]; maskadd
    [B, 1|T, T] f32 additive; seed int32 [1]; weights as `fused_enc_layer`
    takes them (wqkv [d, 3d], w1 [d, f], w2 [f, d], vectors 1-D)."""
    x2 = _self_fwd(x, maskadd, seed, wqkv, bqkv, wo, bo, l1s, l1b, n_heads,
                   rate)
    return _ffn_fwd(x2, seed, w1, b1, w2, b2, l2s, l2b, n_heads, rate), x2


def _drop_bwd(g32, seed, site, n_heads, rate, dt):
    """An f32 cotangent through a dropout site (f32 division), rounded to
    dt's values: the Pallas kernel's df / do and their casts dfc / doc."""
    return rounded(drop_site(g32, seed, site, n_heads, rate), dt)


def ffn_bwd_plain(x2, g, seed, w1, b1, w2, ls, lb, *, n_heads: int,
                  rate: float, relu_active=None):
    """The Pallas `_bwd_ffn_kernel`: out = x2 + drop3(W2 drop2(relu(W1
    LN(x2)))); returns (dx2, dw1, db1, dw2, db2, dls, dlb), dx2 with the
    residual path in x2's type, the rest f32. `relu_active` [B, T, f]
    bool, where given, replaces the recomputed relu pattern hlin > 0
    (wherever the dropout keeps): a comparison with a kernel passes the
    kernel's own pattern, so that a pre-activation within rounding of 0
    cannot take the two apart. With a bf16 x2 the cotangents are rounded
    where the Pallas kernel casts them (dfc, dlinc) and each bias gradient
    sums the rounded cotangent, as the CUDA kernel does."""
    dt = x2.dtype
    y = ln_train_plain(x2, ls, lb, EPS)
    hlin = _lin(y, w1, b1, dt)
    hd = drop_site(torch.relu(hlin), seed, 2, n_heads, rate)
    g32 = up(g)
    df = _drop_bwd(g32, seed, 3, n_heads, rate, dt)
    dhd = drop_site(df @ up(w2).T, seed, 2, n_heads, rate)
    active = hlin > 0 if relu_active is None else relu_active
    dlin = rounded(torch.where(active, dhd, 0.0), dt)
    dy = dlin @ up(w1).T
    dx_ln, dls, dlb = ln_bwd_f32(x2, ls, dy, EPS)
    return ((g32 + dx_ln).to(dt), _wgrad(y, dlin), _rows(dlin).sum(0),
            _wgrad(hd, df), _rows(df).sum(0), dls, dlb)


def _attn_half_bwd(q, k, v, maskadd, seed, g, wo, n_heads, rate):
    """From the gradient g of x + drop1(attn(q, k, v) Wo + bo) to (do, dq,
    dk, dv), do the gradient of the output projection's output (f32,
    rounded to q's type's values), dq / dk / dv in q's type."""
    dt = q.dtype
    do = _drop_bwd(up(g), seed, 1, n_heads, rate, dt)
    dao = (do @ up(wo).T).to(dt)
    dq, dk, dv = mha_train_plain_bwd(q, k, v, maskadd, seed, dao,
                                     n_heads=n_heads, rate=rate,
                                     n_sites=N_SITES)
    return do, dq, dk, dv


def attn_bwd_plain(x, maskadd, g2, seed, wqkv, bqkv, wo, ls, lb, *,
                   n_heads: int, rate: float):
    """The Pallas `_bwd_attn_kernel`: x2 = x + drop1(Wo attn(Wqkv LN(x)));
    returns (dx, dwqkv, dbqkv, dwo, dbo, dls, dlb), dx with the residual
    in x's type, the rest f32."""
    d, dt = x.shape[-1], x.dtype
    y = ln_train_plain(x, ls, lb, EPS)
    qkv = _lin(y, wqkv, bqkv, dt)
    q, k, v = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
    ao = _attention(q, k, v, maskadd, seed, n_heads, rate)
    do, dq, dk, dv = _attn_half_bwd(q, k, v, maskadd, seed, g2, wo, n_heads,
                                    rate)
    dqkv = up(torch.cat([dq, dk, dv], dim=-1))
    dx_ln, dls, dlb = ln_bwd_f32(x, ls, dqkv @ up(wqkv).T, EPS)
    return ((up(g2) + dx_ln).to(dt), _wgrad(y, dqkv), _rows(dqkv).sum(0),
            _wgrad(ao, do), _rows(do).sum(0), dls, dlb)


def _in_types(grads, weights):
    """Each weight gradient (summed in f32) in its weight's type."""
    return tuple(g.to(w.dtype) for g, w in zip(grads, weights))


def enc_bwd_plain(x, maskadd, seed, x2, g, wqkv, bqkv, wo, bo, w1, b1, w2,
                  b2, l1s, l1b, l2s, l2b, *, n_heads: int, rate: float,
                  relu_active=None):
    """(dx, then the gradients of the 12 weights in ENC_WEIGHTS order, each
    in its weight's type); `relu_active` as `ffn_bwd_plain` takes it."""
    kw = dict(n_heads=n_heads, rate=rate)
    dx2, dw1, db1, dw2, db2, dl2s, dl2b = ffn_bwd_plain(
        x2, g, seed, w1, b1, w2, l2s, l2b, relu_active=relu_active, **kw)
    dx, dwqkv, dbqkv, dwo, dbo, dl1s, dl1b = attn_bwd_plain(
        x, maskadd, dx2, seed, wqkv, bqkv, wo, l1s, l1b, **kw)
    return (dx,) + _in_types(
        (dwqkv, dbqkv, dwo, dbo, dw1, db1, dw2, db2, dl1s, dl1b, dl2s, dl2b),
        (wqkv, bqkv, wo, bo, w1, b1, w2, b2, l1s, l1b, l2s, l2b))


def dec_fwd_plain(x, mk, mv, tgt_maskadd, src_maskadd, seeds, wqkv, bqkv,
                  wo, bo, wq, bq, wo2, bo2, w1, b1, w2, b2, l1s, l1b, l2s,
                  l2b, l3s, l3b, *, n_heads: int, rate: float):
    """(out, x2, x3): the Pallas `_dec_fwd_kernel`. mk / mv [B, S, d];
    tgt_maskadd [B, T, T]; src_maskadd [B, 1, S]; seeds int32 [2]."""
    seed, seed2 = seeds[0:1], seeds[1:2]
    dt = x.dtype
    x2 = _self_fwd(x, tgt_maskadd, seed, wqkv, bqkv, wo, bo, l1s, l1b,
                   n_heads, rate)
    qc = _lin(ln_train_plain(x2, l2s, l2b, EPS), wq, bq, dt)
    co = _attention(qc, mk, mv, src_maskadd, seed2, n_heads, rate)
    x3 = x2 + drop_site(_lin(co, wo2, bo2, dt), seed2, 1, n_heads, rate)
    out = _ffn_fwd(x3, seed, w1, b1, w2, b2, l3s, l3b, n_heads, rate)
    return out, x2, x3


def cross_bwd_plain(x2, mk, mv, src_maskadd, g3, seed2, wq, bq, wo2, ls, lb,
                    *, n_heads: int, rate: float):
    """The Pallas `_bwd_cross_kernel`: x3 = x2 + drop1'(Wo2 attn(Wq LN(x2),
    mk, mv)); returns (dx2, dmk, dmv, dwq, dbq, dwo2, dbo2, dls, dlb), dx2,
    dmk and dmv in x2's type, the rest f32."""
    dt = x2.dtype
    y = ln_train_plain(x2, ls, lb, EPS)
    qc = _lin(y, wq, bq, dt)
    co = _attention(qc, mk, mv, src_maskadd, seed2, n_heads, rate)
    do, dqc, dmk, dmv = _attn_half_bwd(qc, mk, mv, src_maskadd, seed2, g3,
                                       wo2, n_heads, rate)
    dqc = up(dqc)
    dx_ln, dls, dlb = ln_bwd_f32(x2, ls, dqc @ up(wq).T, EPS)
    return ((up(g3) + dx_ln).to(dt), dmk, dmv, _wgrad(y, dqc),
            _rows(dqc).sum(0), _wgrad(co, do), _rows(do).sum(0), dls, dlb)


def dec_bwd_plain(x, mk, mv, tgt_maskadd, src_maskadd, seeds, x2, x3, g,
                  wqkv, bqkv, wo, bo, wq, bq, wo2, bo2, w1, b1, w2, b2, l1s,
                  l1b, l2s, l2b, l3s, l3b, *, n_heads: int, rate: float,
                  relu_active=None):
    """(dx, dmk, dmv, then the gradients of the 18 weights in DEC_WEIGHTS
    order, each in its weight's type): the FFN half, the cross half, the
    self-attention half; `relu_active` as `ffn_bwd_plain` takes it."""
    kw = dict(n_heads=n_heads, rate=rate)
    dx3, dw1, db1, dw2, db2, dl3s, dl3b = ffn_bwd_plain(
        x3, g, seeds[0:1], w1, b1, w2, l3s, l3b, relu_active=relu_active,
        **kw)
    dx2, dmk, dmv, dwq, dbq, dwo2, dbo2, dl2s, dl2b = cross_bwd_plain(
        x2, mk, mv, src_maskadd, dx3, seeds[1:2], wq, bq, wo2, l2s, l2b,
        **kw)
    dx, dwqkv, dbqkv, dwo, dbo, dl1s, dl1b = attn_bwd_plain(
        x, tgt_maskadd, dx2, seeds[0:1], wqkv, bqkv, wo, l1s, l1b, **kw)
    return (dx, dmk, dmv) + _in_types(
        (dwqkv, dbqkv, dwo, dbo, dwq, dbq, dwo2, dbo2, dw1, db1, dw2, db2,
         dl1s, dl1b, dl2s, dl2b, dl3s, dl3b),
        (wqkv, bqkv, wo, bo, wq, bq, wo2, bo2, w1, b1, w2, b2, l1s, l1b, l2s,
         l2b, l3s, l3b))
