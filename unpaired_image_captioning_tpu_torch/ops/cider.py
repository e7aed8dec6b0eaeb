"""On-device CIDEr-D and BLEU-4 for SCST rewards (counterpart of
`unpaired_image_captioning_tpu/ops/cider.py`).

The reward is a tensor program on the sequences' device; the sampled ids
never go to the host:

- n-grams (n = 1..4) are identified by two independent 32-bit rolling
  hashes of the token window, the JAX package's bit for bit. The uint32
  arithmetic wraps: here it runs in int64 and is masked to 32 bits after
  every multiply and add (the products stay below 2^57);
- the `prepro_ngrams` document frequencies become an open-addressing hash
  table on the device (`DfTable`), built on the host by `build_df_table`;
  a probe gathers all `_PROBES` slots of a key's chain at once and takes
  the first hit, which is the JAX package's 16-iteration loop (a hit
  freezes its index there, so nothing after it changes the result);
- per-sentence tf counts, idf weights, norms and the clipped tf-idf cosine
  of CIDEr-D (gaussian length penalty, sigma 6, x10) are O(T^2) comparison
  matrices, batched over [batch, refs] and, in `cider_d`, over the four
  orders.

Semantics are the reference's ciderD_scorer.py: vec[n][g] = tf * (log N -
log df), length = the bigram tf total, sim sums min(vec_h, vec_r) * vec_r,
score = 10 x mean over n of the mean over references.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from ..models.base import resolve_device

MAX_N = 4
SIGMA = 6.0
_P1 = 1000003
_P2 = 16777619
_H1_0 = 2166136261
_H2_0 = 5381
_MASK = 0xFFFFFFFF
_PROBES = 16


def _host_hash(ngram: Tuple[int, ...]) -> Tuple[int, int]:
    h1, h2 = _H1_0, _H2_0
    for tok in ngram:
        t = (tok + 1) & _MASK
        h1 = ((h1 * _P1) & _MASK) ^ t
        h2 = ((h2 * _P2) + t) & _MASK
    # mix in the n-gram order so (a,) and (a, pad) cannot alias
    h1 = ((h1 * _P1) & _MASK) ^ len(ngram)
    h2 = ((h2 * _P2) + len(ngram)) & _MASK
    return h1, h2


class DfTable(NamedTuple):
    """Open-addressing df table as device tensors."""

    h1: torch.Tensor    # [M] int64: the uint32 key hash 1 (probe start)
    h2: torch.Tensor    # [M] int64: the uint32 key hash 2 (verify, step)
    df: torch.Tensor    # [M] float32 document frequency
    log_ref_len: float  # log(#reference docs) for idf

    @property
    def size(self) -> int:
        return self.h1.shape[0]


def build_df_table(document_frequency: Dict[Tuple[int, ...], float],
                   ref_len: float, device="cuda") -> DfTable:
    """Host side: an n-gram-id-tuple -> df mapping to a hash table on
    `device`.

    `document_frequency` is the prepro_ngrams artifact keyed by token-id
    tuples; `ref_len` is the raw document count N (idf uses log N - log df).
    """
    dev = resolve_device(device)
    m = max(8, 1 << int(np.ceil(np.log2(
        max(1, len(document_frequency)) * 2 + 1))))
    h1s = np.zeros((m,), np.int64)
    h2s = np.zeros((m,), np.int64)
    dfs = np.zeros((m,), np.float32)
    used = np.zeros((m,), bool)
    for ngram, df in document_frequency.items():
        a, b = _host_hash(tuple(int(t) for t in ngram))
        idx = a % m
        step = (b | 1) % m or 1
        for _ in range(m):
            if not used[idx]:
                used[idx] = True
                h1s[idx] = a
                h2s[idx] = b
                dfs[idx] = df
                break
            if h1s[idx] == a and h2s[idx] == b:
                break  # duplicate key
            idx = (idx + step) % m
    return DfTable(torch.from_numpy(h1s).to(dev),
                   torch.from_numpy(h2s).to(dev),
                   torch.from_numpy(dfs).to(dev),
                   float(np.log(max(1.0, ref_len))))


def empty_df_table(device="cuda") -> DfTable:
    """Placeholder table: every df is 0 and log N is 0, so every idf, and
    with it every CIDEr-D score, is 0 (train-time SCST loads the prepro
    table)."""
    dev = resolve_device(device)
    return DfTable(torch.zeros((8,), dtype=torch.int64, device=dev),
                   torch.zeros((8,), dtype=torch.int64, device=dev),
                   torch.zeros((8,), dtype=torch.float32, device=dev), 0.0)


def _df_lookup(table: DfTable, h1: torch.Tensor, h2: torch.Tensor
               ) -> torch.Tensor:
    """Batched probe: the df of each (h1, h2) key, 0.0 when absent. h1 / h2:
    any shape, int64 holding uint32 values. All `_PROBES` slots of each
    key's chain, idx_k = (h1 % m + k * step) % m, are gathered at once and
    the first hit is taken."""
    m = table.size
    step = torch.clamp((h2 | 1) % m, min=1)
    k = torch.arange(_PROBES, dtype=torch.int64, device=h1.device)
    idx = ((h1 % m)[..., None] + k * step[..., None]) % m     # [..., P]
    hit = (table.h1[idx] == h1[..., None]) & (table.h2[idx] == h2[..., None])
    first = torch.argmax(hit.to(torch.uint8), dim=-1, keepdim=True)
    val = torch.gather(table.df[idx], -1, first)[..., 0]
    return torch.where(hit.any(-1), val, torch.zeros_like(val))


def _hash_orders(seq: torch.Tensor, orders):
    """seq: [..., T] int (0-padded). (h1, h2, valid) of each order n in
    `orders` (ascending), each [..., T], where position i covers tokens
    i..i+n-1; h1 and h2 are int64 tensors holding the uint32 hashes (the
    JAX package's `ngram_hashes` of each order). The rolling hash of order
    n extends that of order n - 1 by one token, so all orders come from
    one pass over n tokens."""
    t = seq.shape[-1]
    h1 = torch.full(seq.shape, _H1_0, dtype=torch.int64, device=seq.device)
    h2 = torch.full(seq.shape, _H2_0, dtype=torch.int64, device=seq.device)
    valid = torch.ones(seq.shape, dtype=torch.bool, device=seq.device)
    pos = torch.arange(t, device=seq.device)
    out = []
    for j in range(max(orders)):
        # positions past T - j wrap: masked below by the position bound
        tok = torch.roll(seq, -j, dims=-1) if j else seq
        tu = (tok.to(torch.int64) + 1) & _MASK
        h1 = ((h1 * _P1) & _MASK) ^ tu
        h2 = ((h2 * _P2) + tu) & _MASK
        valid = valid & (tok > 0)
        n = j + 1
        if n in orders:
            out.append((((h1 * _P1) & _MASK) ^ n,
                        ((h2 * _P2) + n) & _MASK,
                        valid & (pos <= t - n)))
    return out


def _stats(h1, h2, valid, table: DfTable) -> dict:
    """Per-sentence n-gram statistics from the hashes ([..., T] each; the
    JAX package's `_sentence_stats`): h1, h2, the canonical slots (first
    of each distinct n-gram), tf counts, idf, the idf-weighted vec values
    g (0 at non-canonical or invalid slots), norm [...] and valid."""
    eq = (h1[..., :, None] == h1[..., None, :]) & (
        h2[..., :, None] == h2[..., None, :])
    eq = eq & valid[..., None, :] & valid[..., :, None]
    tf = eq.sum(-1).to(torch.float32)                         # [..., T]
    t = h1.shape[-1]
    lower = torch.tril(torch.ones((t, t), dtype=torch.bool,
                                  device=h1.device), diagonal=-1)
    dup_before = (eq & lower).any(-1)
    canonical = valid & ~dup_before
    df = _df_lookup(table, h1, h2)
    idf = table.log_ref_len - torch.log(torch.clamp(df, min=1.0))
    g = torch.where(canonical, tf * idf, torch.zeros_like(tf))
    norm = torch.sqrt((g * g).sum(-1))
    return {"h1": h1, "h2": h2, "canonical": canonical, "tf": tf,
            "idf": idf, "g": g, "norm": norm, "valid": valid}


def _pair_sim(cand: dict, ref: dict) -> torch.Tensor:
    """Clipped tf-idf dot between candidate and reference stats ([..., T]
    each): for each canonical candidate slot, the matching canonical
    reference slot (same n-gram) adds min(g_c, g_r) * g_r."""
    match = (cand["h1"][..., :, None] == ref["h1"][..., None, :]) & (
        cand["h2"][..., :, None] == ref["h2"][..., None, :])
    match = match & ref["canonical"][..., None, :] & cand["canonical"][
        ..., :, None]
    tf_r = torch.where(match, ref["tf"][..., None, :],
                       torch.zeros((), device=match.device)).sum(-1)
    g_r = tf_r * cand["idf"]     # same n-gram -> same idf
    num = (torch.minimum(cand["g"], g_r) * g_r).sum(-1)
    denom = cand["norm"] * ref["norm"]
    return torch.where(denom > 0, num / torch.clamp(denom, min=1e-12),
                       torch.zeros_like(num))


def cider_d(cand_seq: torch.Tensor, ref_seqs: torch.Tensor,
            ref_mask: torch.Tensor, table: DfTable) -> torch.Tensor:
    """CIDEr-D scores. cand_seq: [B, T]; ref_seqs: [B, R, Tr]; ref_mask:
    [B, R], 1 for real references. Returns [B] float32 (x10 scaled).

    The four orders run as one batch: the stats carry a leading order axis
    [MAX_N, ...], and the candidate is compared with each reference over
    [MAX_N, B, R, T, Tr]."""
    b, r = ref_seqs.shape[:2]
    orders = tuple(range(1, MAX_N + 1))
    refs = ref_seqs.reshape(b * r, -1)

    def stacked(seq):
        hs = _hash_orders(seq, orders)
        return [torch.stack(x) for x in zip(*hs)], hs[1][2]

    (c1, c2, cv), c_bi = stacked(cand_seq)                    # [N, B, T]
    (r1, r2, rv), r_bi = stacked(refs)                        # [N, B*R, Tr]
    c = _stats(c1, c2, cv, table)
    rs = {k: v.reshape((MAX_N, b, r) + v.shape[2:])
          for k, v in _stats(r1, r2, rv, table).items()}
    c = {k: v[:, :, None] for k, v in c.items()}              # [N, B, 1, ...]
    sim = _pair_sim(c, rs)                                    # [N, B, R]
    # the gaussian penalty's length is the bigram tf total (ciderD parity)
    len_c = c_bi.sum(-1).to(torch.float32)                    # [B]
    len_r = r_bi.sum(-1).to(torch.float32).reshape(b, r)
    delta = len_c[:, None] - len_r
    sim = sim * torch.exp(-(delta ** 2) / (2 * SIGMA ** 2))
    sim = torch.where(ref_mask > 0, sim, torch.zeros_like(sim))
    n_refs = torch.clamp(ref_mask.sum(-1), min=1.0)
    # the orders are summed one after another, as the JAX loop adds them
    total = sim.sum(-1) / n_refs                              # [N, B]
    score = total[0]
    for n in range(1, MAX_N):
        score = score + total[n]
    return score / MAX_N * 10.0


def bleu4(cand_seq: torch.Tensor, ref_seqs: torch.Tensor,
          ref_mask: torch.Tensor) -> torch.Tensor:
    """Per-sentence smoothed BLEU-4 on the device (reward use; the
    reference's Bleu(4) per-image scores use +1 smoothing for n >= 2).
    Returns [B] float32."""
    b, r = ref_seqs.shape[:2]
    tiny = 1e-9
    logsum = torch.zeros((b,), dtype=torch.float32, device=cand_seq.device)
    len_c = (cand_seq > 0).sum(-1).to(torch.float32)
    len_r = (ref_seqs > 0).sum(-1).to(torch.float32)          # [B, R]
    big = torch.where(ref_mask > 0, torch.abs(len_r - len_c[:, None]),
                      torch.full_like(len_r, 1e9))
    closest = torch.gather(len_r, 1, torch.argmin(big, -1)[:, None])[:, 0]
    orders = tuple(range(1, MAX_N + 1))
    cand_h = _hash_orders(cand_seq, orders)
    ref_h = _hash_orders(ref_seqs.reshape(b * r, -1), orders)
    t = cand_seq.shape[-1]
    lower = torch.tril(torch.ones((t, t), dtype=torch.bool,
                                  device=cand_seq.device), diagonal=-1)
    for n, (c1, c2, cv), (r1, r2, rv) in zip(orders, cand_h, ref_h):
        r1, r2, rv = (x.reshape(b, r, -1) for x in (r1, r2, rv))
        # candidate tf and canonical slots
        eq = (c1[:, :, None] == c1[:, None, :]) & (
            c2[:, :, None] == c2[:, None, :])
        eq = eq & cv[:, None, :] & cv[:, :, None]
        tf_c = eq.sum(-1).to(torch.float32)
        canon = cv & ~(eq & lower).any(-1)
        # each reference's tf of each candidate n-gram; clipped = max over refs
        m = (c1[:, None, :, None] == r1[:, :, None, :]) & (
            c2[:, None, :, None] == r2[:, :, None, :])
        m = m & rv[:, :, None, :]
        tf_r = m.sum(-1).to(torch.float32)                    # [B, R, T]
        tf_r = torch.where(ref_mask[..., None] > 0, tf_r,
                           torch.zeros_like(tf_r))
        tf_max = tf_r.max(dim=1).values                       # [B, T]
        clipped = torch.where(canon, torch.minimum(tf_c, tf_max),
                              torch.zeros_like(tf_c)).sum(-1)
        total = cv.sum(-1).to(torch.float32)
        add = 1.0 if n >= 2 else 0.0
        p = (clipped + add) / torch.clamp(total + add, min=tiny)
        p = torch.where(total > 0, p, torch.full_like(p, tiny))
        logsum = logsum + torch.log(torch.clamp(p, min=tiny))
    ratio = len_c / torch.clamp(closest, min=tiny)
    bp = torch.where(ratio > 1.0, torch.ones_like(ratio),
                     torch.exp(1.0 - 1.0 / torch.clamp(ratio, min=tiny)))
    return torch.exp(logsum / MAX_N) * bp
