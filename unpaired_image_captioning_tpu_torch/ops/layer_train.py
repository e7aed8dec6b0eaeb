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
"""

from __future__ import annotations

import torch

from .ln_train import ln_train_plain, ln_train_plain_bwd
from .mha_train import keep_mask, mha_train_plain, mha_train_plain_bwd

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
    `site` (h = 0); x itself at rate 0."""
    if rate <= 0.0:
        return x
    b, t, c = x.shape
    keep = keep_mask(seed, b, n_heads, t, c, rate, n_sites=N_SITES,
                     site=site, heads=1)[:, 0]
    return torch.where(keep, x / (1.0 - rate), 0.0)


def _rows(x):
    return x.reshape(-1, x.shape[-1])


def _wgrad(a, g):
    """sum over the batch of a^T g: [B, T, m] x [B, T, n] -> [m, n]."""
    return _rows(a).T @ _rows(g)


def _attention(q, k, v, maskadd, seed, n_heads, rate):
    return mha_train_plain(q, k, v, maskadd, seed, n_heads=n_heads,
                           rate=rate, n_sites=N_SITES)


def _self_fwd(x, maskadd, seed, wqkv, bqkv, wo, bo, ls, lb, n_heads, rate):
    d = x.shape[-1]
    qkv = ln_train_plain(x, ls, lb, EPS) @ wqkv + bqkv
    ao = _attention(qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:],
                    maskadd, seed, n_heads, rate)
    return x + drop_site(ao @ wo + bo, seed, 1, n_heads, rate)


def _ffn_fwd(x, seed, w1, b1, w2, b2, ls, lb, n_heads, rate):
    h = torch.relu(ln_train_plain(x, ls, lb, EPS) @ w1 + b1)
    hd = drop_site(h, seed, 2, n_heads, rate)
    return x + drop_site(hd @ w2 + b2, seed, 3, n_heads, rate)


def enc_fwd_plain(x, maskadd, seed, wqkv, bqkv, wo, bo, w1, b1, w2, b2,
                  l1s, l1b, l2s, l2b, *, n_heads: int, rate: float):
    """(out, x2): the Pallas `_fwd_kernel`. x [B, T, d]; maskadd
    [B, 1|T, T] f32 additive; seed int32 [1]; weights as `fused_enc_layer`
    takes them (wqkv [d, 3d], w1 [d, f], w2 [f, d], vectors 1-D)."""
    x2 = _self_fwd(x, maskadd, seed, wqkv, bqkv, wo, bo, l1s, l1b, n_heads,
                   rate)
    return _ffn_fwd(x2, seed, w1, b1, w2, b2, l2s, l2b, n_heads, rate), x2


def ffn_bwd_plain(x2, g, seed, w1, b1, w2, ls, lb, *, n_heads: int,
                  rate: float, relu_active=None):
    """The Pallas `_bwd_ffn_kernel`: out = x2 + drop3(W2 drop2(relu(W1
    LN(x2)))); returns (dx2, dw1, db1, dw2, db2, dls, dlb), dx2 with the
    residual path. `relu_active` [B, T, f] bool, where given, replaces the
    recomputed relu pattern hlin > 0 (wherever the dropout keeps): a
    comparison with a kernel passes the kernel's own pattern, so that a
    pre-activation within rounding of 0 cannot take the two apart."""
    y = ln_train_plain(x2, ls, lb, EPS)
    hlin = y @ w1 + b1
    hd = drop_site(torch.relu(hlin), seed, 2, n_heads, rate)
    df = drop_site(g, seed, 3, n_heads, rate)
    dhd = drop_site(df @ w2.T, seed, 2, n_heads, rate)
    active = hlin > 0 if relu_active is None else relu_active
    dlin = torch.where(active, dhd, 0.0)
    dy = dlin @ w1.T
    dx_ln, dls, dlb = ln_train_plain_bwd(x2, ls, dy, EPS)
    return (g + dx_ln, _wgrad(y, dlin), _rows(dlin).sum(0), _wgrad(hd, df),
            _rows(df).sum(0), dls, dlb)


def _attn_half_bwd(q, k, v, maskadd, seed, g, wo, n_heads, rate):
    """From the gradient g of x + drop1(attn(q, k, v) Wo + bo) to (do, dq,
    dk, dv), do the gradient of the output projection's output."""
    do = drop_site(g, seed, 1, n_heads, rate)
    dao = do @ wo.T
    dq, dk, dv = mha_train_plain_bwd(q, k, v, maskadd, seed, dao,
                                     n_heads=n_heads, rate=rate,
                                     n_sites=N_SITES)
    return do, dq, dk, dv


def attn_bwd_plain(x, maskadd, g2, seed, wqkv, bqkv, wo, ls, lb, *,
                   n_heads: int, rate: float):
    """The Pallas `_bwd_attn_kernel`: x2 = x + drop1(Wo attn(Wqkv LN(x)));
    returns (dx, dwqkv, dbqkv, dwo, dbo, dls, dlb), dx with the residual."""
    d = x.shape[-1]
    y = ln_train_plain(x, ls, lb, EPS)
    qkv = y @ wqkv + bqkv
    q, k, v = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
    ao = _attention(q, k, v, maskadd, seed, n_heads, rate)
    do, dq, dk, dv = _attn_half_bwd(q, k, v, maskadd, seed, g2, wo, n_heads,
                                    rate)
    dqkv = torch.cat([dq, dk, dv], dim=-1)
    dx_ln, dls, dlb = ln_train_plain_bwd(x, ls, dqkv @ wqkv.T, EPS)
    return (g2 + dx_ln, _wgrad(y, dqkv), _rows(dqkv).sum(0), _wgrad(ao, do),
            _rows(do).sum(0), dls, dlb)


def enc_bwd_plain(x, maskadd, seed, x2, g, wqkv, bqkv, wo, bo, w1, b1, w2,
                  b2, l1s, l1b, l2s, l2b, *, n_heads: int, rate: float,
                  relu_active=None):
    """(dx, then the gradients of the 12 weights in ENC_WEIGHTS order);
    `relu_active` as `ffn_bwd_plain` takes it."""
    kw = dict(n_heads=n_heads, rate=rate)
    dx2, dw1, db1, dw2, db2, dl2s, dl2b = ffn_bwd_plain(
        x2, g, seed, w1, b1, w2, l2s, l2b, relu_active=relu_active, **kw)
    dx, dwqkv, dbqkv, dwo, dbo, dl1s, dl1b = attn_bwd_plain(
        x, maskadd, dx2, seed, wqkv, bqkv, wo, l1s, l1b, **kw)
    return (dx, dwqkv, dbqkv, dwo, dbo, dw1, db1, dw2, db2, dl1s, dl1b, dl2s,
            dl2b)


def dec_fwd_plain(x, mk, mv, tgt_maskadd, src_maskadd, seeds, wqkv, bqkv,
                  wo, bo, wq, bq, wo2, bo2, w1, b1, w2, b2, l1s, l1b, l2s,
                  l2b, l3s, l3b, *, n_heads: int, rate: float):
    """(out, x2, x3): the Pallas `_dec_fwd_kernel`. mk / mv [B, S, d];
    tgt_maskadd [B, T, T]; src_maskadd [B, 1, S]; seeds int32 [2]."""
    seed, seed2 = seeds[0:1], seeds[1:2]
    x2 = _self_fwd(x, tgt_maskadd, seed, wqkv, bqkv, wo, bo, l1s, l1b,
                   n_heads, rate)
    qc = ln_train_plain(x2, l2s, l2b, EPS) @ wq + bq
    co = _attention(qc, mk, mv, src_maskadd, seed2, n_heads, rate)
    x3 = x2 + drop_site(co @ wo2 + bo2, seed2, 1, n_heads, rate)
    out = _ffn_fwd(x3, seed, w1, b1, w2, b2, l3s, l3b, n_heads, rate)
    return out, x2, x3


def cross_bwd_plain(x2, mk, mv, src_maskadd, g3, seed2, wq, bq, wo2, ls, lb,
                    *, n_heads: int, rate: float):
    """The Pallas `_bwd_cross_kernel`: x3 = x2 + drop1'(Wo2 attn(Wq LN(x2),
    mk, mv)); returns (dx2, dmk, dmv, dwq, dbq, dwo2, dbo2, dls, dlb)."""
    y = ln_train_plain(x2, ls, lb, EPS)
    qc = y @ wq + bq
    co = _attention(qc, mk, mv, src_maskadd, seed2, n_heads, rate)
    do, dqc, dmk, dmv = _attn_half_bwd(qc, mk, mv, src_maskadd, seed2, g3,
                                       wo2, n_heads, rate)
    dx_ln, dls, dlb = ln_train_plain_bwd(x2, ls, dqc @ wq.T, EPS)
    return (g3 + dx_ln, dmk, dmv, _wgrad(y, dqc), _rows(dqc).sum(0),
            _wgrad(co, do), _rows(do).sum(0), dls, dlb)


def dec_bwd_plain(x, mk, mv, tgt_maskadd, src_maskadd, seeds, x2, x3, g,
                  wqkv, bqkv, wo, bo, wq, bq, wo2, bo2, w1, b1, w2, b2, l1s,
                  l1b, l2s, l2b, l3s, l3b, *, n_heads: int, rate: float,
                  relu_active=None):
    """(dx, dmk, dmv, then the gradients of the 18 weights in DEC_WEIGHTS
    order): the FFN half, the cross half, the self-attention half;
    `relu_active` as `ffn_bwd_plain` takes it."""
    kw = dict(n_heads=n_heads, rate=rate)
    dx3, dw1, db1, dw2, db2, dl3s, dl3b = ffn_bwd_plain(
        x3, g, seeds[0:1], w1, b1, w2, l3s, l3b, relu_active=relu_active,
        **kw)
    dx2, dmk, dmv, dwq, dbq, dwo2, dbo2, dl2s, dl2b = cross_bwd_plain(
        x2, mk, mv, src_maskadd, dx3, seeds[1:2], wq, bq, wo2, l2s, l2b,
        **kw)
    dx, dwqkv, dbqkv, dwo, dbo, dl1s, dl1b = attn_bwd_plain(
        x, tgt_maskadd, dx2, seeds[0:1], wqkv, bqkv, wo, l1s, l1b, **kw)
    return (dx, dmk, dmv, dwqkv, dbqkv, dwo, dbo, dwq, dbq, dwo2, dbo2, dw1,
            db1, dw2, db2, dl1s, dl1b, dl2s, dl2b, dl3s, dl3b)
