"""Training multi-head attention, plain PyTorch (counterpart of
`unpaired_image_captioning_tpu/ops/mha_train.py`).

The function of the Pallas `fused_mha_train` and of its CUDA port
(`kernels/mha_train.py`, `csrc/mha_train.cu`), per batch element b and
head h, with q [B, T, d] already q-projected, k / v [B, S, d] projected,
`maskadd` [B, 1|T, S] f32 (0 keep, -1e9 drop) and `seed` int32 [1]:

    s = q_h k_h^T / sqrt(dh);  s = -1e9 where maskadd < 0
    p = softmax(s);  attn = keep ? p / (1 - rate) : 0;  o_h = attn v_h

`keep` is `_keep_mask` of the Pallas kernel, a splitmix32 hash of (seed,
pid, row * S + col) against floor(rate * 2^32) with the block id
pid = (b * n_sites + site) * n_heads + h: n_sites 1 here (pid = b * H + h);
the whole-layer kernels (`ops/layer_train.py`) draw 4 sites per batch
element, the attention probabilities at site 0. The plain version, the
Pallas kernel in interpret mode and the CUDA kernel draw the same mask from
the same seed. The backward (`mha_train_plain_bwd`) is the
Pallas `_bwd_kernel` written out: it recomputes p and the mask, and masked
scores get zero gradient.
"""

from __future__ import annotations

import math

import torch

NEG = -1e9
_M32 = 0xFFFFFFFF


def keep_threshold(rate: float) -> int:
    """The uint32 threshold a hash must reach to keep its element."""
    return min(int(rate * (2.0 ** 32)), 2 ** 32 - 1)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32): the product is split in
    16-bit halves of c so that no int64 product overflows."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def keep_mask(seed: torch.Tensor, b: int, n_heads: int, t: int, s: int,
              rate: float, *, n_sites: int = 1, site: int = 0,
              heads: int | None = None) -> torch.Tensor:
    """[B, heads, T, S] bool: the elements the dropout keeps in the blocks
    pid = (b * n_sites + site) * n_heads + h, h < heads (default n_heads).
    A residual or FFN site of the whole-layer kernels is heads=1 (h = 0)."""
    dev = seed.device
    seed32 = seed.reshape(()).long() & _M32
    heads = n_heads if heads is None else heads
    pid = ((torch.arange(b, device=dev) * n_sites + site)[:, None] * n_heads
           + torch.arange(heads, device=dev)[None, :]).reshape(b, heads, 1, 1)
    base = _mul32(seed32.expand_as(pid), 0x9E3779B9) ^ _mul32(pid, 0x85EBCA6B)
    idx = (torch.arange(t, device=dev)[:, None] * s
           + torch.arange(s, device=dev)[None, :])
    x = base ^ _mul32(idx, 0x2545F491)
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    x = x ^ (x >> 16)
    return x >= keep_threshold(rate)


def _heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.reshape(b, t, n_heads, d // n_heads)


def _probs(q, k, maskadd, seed, n_heads: int, rate: float, n_sites: int):
    """(p, attn, keep or None) [B, H, T, S]; attn includes the dropout."""
    b, t, d = q.shape
    dh = d // n_heads
    scores = torch.einsum("bthd,bshd->bhts", _heads(q, n_heads),
                          _heads(k, n_heads)) / math.sqrt(dh)
    scores = torch.where(maskadd[:, None] < 0, NEG, scores)
    p = torch.softmax(scores, dim=-1)
    if rate <= 0.0:
        return p, p, None
    keep = keep_mask(seed, b, n_heads, t, k.shape[1], rate, n_sites=n_sites)
    return p, torch.where(keep, p / (1.0 - rate), 0.0), keep


def mha_train_plain(q, k, v, maskadd, seed, *, n_heads: int, rate: float,
                    n_sites: int = 1):
    """Merged-head attention output [B, T, d]; the output projection stays
    outside. `n_sites` is the block-id stride of the dropout hash (site 0)."""
    b, t, d = q.shape
    _, attn, _ = _probs(q, k, maskadd, seed, n_heads, rate, n_sites)
    out = torch.einsum("bhts,bshd->bthd", attn, _heads(v, n_heads))
    return out.reshape(b, t, d)


def mha_train_plain_bwd(q, k, v, maskadd, seed, g, *, n_heads: int,
                        rate: float, n_sites: int = 1):
    """(dq, dk, dv) for the upstream gradient g [B, T, d]."""
    b, t, d = q.shape
    s = k.shape[1]
    dh = d // n_heads
    p, attn, keep = _probs(q, k, maskadd, seed, n_heads, rate, n_sites)
    gh = _heads(g, n_heads)
    dv = torch.einsum("bhts,bthd->bshd", attn, gh)
    dattn = torch.einsum("bthd,bshd->bhts", gh, _heads(v, n_heads))
    if keep is not None:
        dattn = torch.where(keep, dattn / (1.0 - rate), 0.0)
    ds = p * (dattn - (dattn * p).sum(-1, keepdim=True))
    ds = torch.where(maskadd[:, None] < 0, 0.0, ds)
    dsd = ds / math.sqrt(dh)
    dq = torch.einsum("bhts,bshd->bthd", dsd, _heads(k, n_heads))
    dk = torch.einsum("bhts,bthd->bshd", dsd, _heads(q, n_heads))
    return dq.reshape(b, t, d), dk.reshape(b, s, d), dv.reshape(b, s, d)
