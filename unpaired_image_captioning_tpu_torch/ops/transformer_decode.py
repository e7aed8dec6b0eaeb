"""Transformer decoder step: weight packing and the plain PyTorch versions
of the decode kernels (counterpart of
`unpaired_image_captioning_tpu/ops/transformer_decode.py`).

One decode step through one pre-norm decoder layer, for R = B*kb rows where
the kb beams of an image are consecutive rows (`_layer_math` there):

1. self-attention: y = LN1(x); [q | k_t | v_t] = y @ Wqkv + bqkv; k_t and
   v_t are written into the row's cache at slot t[r]; each head attends
   over the positions tau <= t[r] with scale 1/sqrt(dh) and masked scores
   set to -1e9; x += out @ Wo_s + bo_s. With `anc` (the lazy beam cache),
   position tau of row r is read from physical row image*kb + anc[r, tau].
2. cross-attention: y = LN2(x); the kb query rows of image b read that
   image's unexpanded [S, d] K/V, masked to -1e9 where src_mask <= 0;
   x += out @ Wo_c + bo_c. The mean over heads of the softmax weights,
   [R, S], is the NMT's UNK-replacement signal (`want_attn`).
3. FFN: x += relu(LN3(x) @ W1 + b1) @ W2 + b2.

LayerNorm is the reference's: unbiased (n-1) variance, eps 1e-6 outside
the sqrt.

In-place contract, shared with the CUDA kernel (`kernels/
transformer_decode.py`): the caches are updated in place (slot t[r] of
every row is overwritten) and returned. A caller that must keep the
pre-step cache copies it first; the caption beam reorders its state with
`index_select`, which copies, and the NMT's lazy caches are append-only.

The wrappers that launch the kernel for CUDA tensors are
`kernels.transformer_decode.decoder_layer_step` / `decoder_stack_step`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG = -1e9      # the reference's masked score (not -inf)

# packed weights of one layer, in the order the CUDA entry points take them
WKEYS = ("ln1_s", "ln1_b", "wqkv", "bqkv", "wo_s", "bo_s", "ln2_s", "ln2_b",
         "wq_c", "bq_c", "wo_c", "bo_c", "ln3_s", "ln3_b", "w1", "b1",
         "w2", "b2")


def pack_layer_weights(lp) -> dict:
    """One decoder layer's weights for the step: the self-attention Q, K, V
    projections fused into wqkv [d, 3d] / bqkv [3d]; biases and LN
    parameters are 1-D. The cross-attention K/V projections are not here:
    the caller applies them to the encoder memory once per sequence."""
    s, c, f = lp["self"], lp["src"], lp["ffn"]
    w = {
        "ln1_s": lp["n1"].scale, "ln1_b": lp["n1"].offset,
        "wqkv": torch.cat([s["q"].w, s["k"].w, s["v"].w], dim=1),
        "bqkv": torch.cat([s["q"].b, s["k"].b, s["v"].b]),
        "wo_s": s["o"].w, "bo_s": s["o"].b,
        "ln2_s": lp["n2"].scale, "ln2_b": lp["n2"].offset,
        "wq_c": c["q"].w, "bq_c": c["q"].b,
        "wo_c": c["o"].w, "bo_c": c["o"].b,
        "ln3_s": lp["n3"].scale, "ln3_b": lp["n3"].offset,
        "w1": f["w1"].w, "b1": f["w1"].b,
        "w2": f["w2"].w, "b2": f["w2"].b,
    }
    return {k: v.detach().contiguous() for k, v in w.items()}


def pack_stack_weights(dec_layers) -> dict:
    """Every layer's packed weights stacked on a leading layer axis:
    {key: [L, *shape]}, contiguous."""
    per_layer = [pack_layer_weights(lp) for lp in dec_layers]
    return {k: torch.stack([p[k] for p in per_layer]) for k in WKEYS}


def src_mask_2d(src_mask: Optional[torch.Tensor], batch: int, slots: int,
                device) -> torch.Tensor:
    """[B, S] f32 (1 = attend) from None (all ones), [B, S] or [B, 1, S]."""
    if src_mask is None:
        return torch.ones((batch, slots), dtype=torch.float32, device=device)
    if src_mask.dim() == 3:
        src_mask = src_mask[:, 0, :]
    return src_mask.to(torch.float32).contiguous()


def layer_norm_plain(x, scale, offset, eps: float = 1e-6):
    """The reference LayerNorm: unbiased (n-1) variance, eps outside the
    sqrt."""
    mean = x.mean(-1, keepdim=True)
    var = torch.square(x - mean).sum(-1, keepdim=True) / (x.shape[-1] - 1)
    return (x - mean) / (torch.sqrt(var) + eps) * scale + offset


def _write_slot(cache, val, t):
    """cache [R, T, d] (may be a view) <- val [R, d] at slot t[r], in place;
    rows whose t is outside [0, T) write nothing."""
    ok = (t >= 0) & (t < cache.shape[1])
    rows = torch.arange(t.shape[0], device=t.device)[ok]
    cache[rows, t[ok].long()] = val[ok]


def _self_attend(q, cache_k, cache_v, t, n_heads: int, kb: int, anc):
    rows, n_t, d = cache_k.shape
    dh = d // n_heads
    if anc is None:
        keys, vals = cache_k, cache_v
    else:
        r = torch.arange(rows, device=q.device)
        phys = (r - r % kb)[:, None] + anc.long()              # [R, T]
        pos = torch.arange(n_t, device=q.device)[None, :].expand(rows, n_t)
        keys, vals = cache_k[phys, pos], cache_v[phys, pos]    # [R, T, d]
    sc = torch.einsum("rhd,rthd->rht", q.reshape(rows, n_heads, dh),
                      keys.reshape(rows, n_t, n_heads, dh)) / math.sqrt(dh)
    ok = torch.arange(n_t, device=q.device)[None, :] <= t[:, None]
    sc = torch.where(ok[:, None, :], sc, torch.full_like(sc, NEG))
    a = torch.softmax(sc, dim=-1)
    out = torch.einsum("rht,rthd->rhd", a,
                       vals.reshape(rows, n_t, n_heads, dh))
    return out.reshape(rows, d)


def cross_attend(q2, ck, cv, mask, n_heads: int):
    """The kb beam queries q2 [B*kb, d] of each image attend over that
    image's unexpanded ck/cv [B, S, d]; mask [B, S] (> 0 = attend). Returns
    (out [B*kb, d], mean-head weights [B*kb, S])."""
    bsz, slots, d = ck.shape
    rows = q2.shape[0]
    kb = rows // bsz
    dh = d // n_heads
    sc = torch.einsum("bkhd,bshd->bhks",
                      q2.reshape(bsz, kb, n_heads, dh),
                      ck.reshape(bsz, slots, n_heads, dh)) / math.sqrt(dh)
    sc = torch.where(mask[:, None, None, :] > 0, sc, torch.full_like(sc, NEG))
    w = torch.softmax(sc, dim=-1)                              # [B, H, kb, S]
    attn = w.mean(dim=1).reshape(rows, slots)
    out = torch.einsum("bhks,bshd->bkhd", w,
                       cv.reshape(bsz, slots, n_heads, dh))
    return out.reshape(rows, d), attn


def _layer_plain(x, t, ck, cv, mask, cache_k, cache_v, w, *, n_heads: int,
                 kb: int, anc=None):
    """One layer; cache_k/v [R, T, d] (views allowed) are written in place.
    Returns (x', mean-head cross-attention weights [R, S])."""
    d = x.shape[-1]
    y = layer_norm_plain(x, w["ln1_s"], w["ln1_b"])
    q, k_t, v_t = (y @ w["wqkv"] + w["bqkv"]).split(d, dim=-1)
    _write_slot(cache_k, k_t, t)
    _write_slot(cache_v, v_t, t)
    out = _self_attend(q, cache_k, cache_v, t, n_heads, kb, anc)
    x = x + (out @ w["wo_s"] + w["bo_s"])
    y = layer_norm_plain(x, w["ln2_s"], w["ln2_b"])
    out2, attn = cross_attend(y @ w["wq_c"] + w["bq_c"], ck, cv, mask,
                              n_heads)
    x = x + (out2 @ w["wo_c"] + w["bo_c"])
    y = layer_norm_plain(x, w["ln3_s"], w["ln3_b"])
    h1 = torch.relu(y @ w["w1"] + w["b1"])
    return x + (h1 @ w["w2"] + w["b2"]), attn


def decoder_layer_step_plain(x, t, ck, cv, src_mask, cache_k, cache_v,
                             wpack, *, n_heads: int):
    """Plain version of one decoder layer for one step.

    x [R, d]; t [R] int per-row positions, >= 0 (a row past the cache
    writes nothing and attends over all T slots); ck/cv [B, S, d] unexpanded
    cross K/V; src_mask [B, S] (1 = attend) or None; cache_k/v [R, T, d],
    written in place at slot t. Returns (x', cache_k, cache_v)."""
    bsz, slots, _ = ck.shape
    mask = src_mask_2d(src_mask, bsz, slots, x.device)
    x, _ = _layer_plain(x, t, ck, cv, mask, cache_k, cache_v, wpack,
                        n_heads=n_heads, kb=x.shape[0] // bsz)
    return x, cache_k, cache_v


def decoder_stack_step_plain(x, t, ck_all, cv_all, src_mask, cache_k,
                             cache_v, wstack, anc=None, *, n_heads: int,
                             want_attn: bool = False):
    """Plain version of all L decoder layers for one step.

    ck_all/cv_all [L, B, S, d]; cache_k/v [R, L, T, d], written in place at
    slot t; wstack from `pack_stack_weights`; anc [R, T] int (optional):
    the lazy beam cache's ancestry (local beam index of the row that wrote
    each position). Returns (x', cache_k, cache_v), plus the LAST layer's
    mean-head cross-attention weights [R, S] f32 when `want_attn`."""
    n_layers, bsz, slots, _ = ck_all.shape
    mask = src_mask_2d(src_mask, bsz, slots, x.device)
    kb = x.shape[0] // bsz
    attn = None
    for layer in range(n_layers):
        w = {k: wstack[k][layer] for k in WKEYS}
        x, attn = _layer_plain(x, t, ck_all[layer], cv_all[layer], mask,
                               cache_k[:, layer], cache_v[:, layer], w,
                               n_heads=n_heads, kb=kb, anc=anc)
    if want_attn:
        return x, cache_k, cache_v, attn
    return x, cache_k, cache_v
