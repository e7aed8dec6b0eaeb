"""Batched beam search over `[batch, beam]` (counterpart of
`unpaired_image_captioning_tpu/ops/beam_search.py`).

Two beams with different semantics, both selecting on the step's natural
`[B*K, V]` layout through `_flat_topk` (the row top-k kernel on CUDA):

- `beam_search`, the caption beam: UNK suppression (-1000 on the last vocab
  slot), optional `decoding_constraint` (no immediate repeat), `max_ppl`
  length-normalized ranking, a beam that emits EOS is recorded as finished
  and its live score becomes exactly -1000 (a selectable "dead slot"),
  every live beam is recorded at the last step, and the loop exits early
  once every live beam is dead. Only one group (`group_size == 1`); diverse
  groups are ROADMAP A10.
- `onmt_beam_search`, the NMT beam: rows that emit EOS keep extending, a
  sentence finishes when EOS is at the top of its beam and then freezes,
  and the result rows are the final beam rows by score, optionally
  with lazy (append-only) caches read through a per-row ancestry table.

The JAX package runs each as one `lax.while_loop`. Here the loop is Python
and its exit test (`any_alive` / `all(done)`) reads one scalar from the
device per step; capturing the step in a CUDA graph is later work.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from .topk import row_topk, sorted_topk

NEG_INF = -1e10
DEAD = -1000.0  # the reference's dead-slot score


class BeamResult(NamedTuple):
    seq: torch.Tensor              # [B, K, T] int64, best first
    logps: torch.Tensor            # [B, K, T] f32 per-token logprobs
    scores: torch.Tensor           # [B, K] f32 total logprob
    aux: Optional[torch.Tensor]    # [B, K, T] int64 recorded aux (or None)


def tree_map(fn, tree, *rest):
    """Map `fn` over the tensor leaves of nested dicts, tuples and lists;
    None leaves stay None."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


def _first_leaf(tree) -> torch.Tensor:
    if isinstance(tree, dict):
        return _first_leaf(next(iter(tree.values())))
    if isinstance(tree, (tuple, list)):
        return _first_leaf(tree[0])
    return tree


def _expand_to_beams(tree, beam_size: int, no_expand=()):
    """[B, ...] -> [B*K, ...] with row b*K+k = row b. Top-level dict keys in
    `no_expand` stay at [B, ...] (memories shared by the K beams). An
    ensemble's ctx is a tuple of member ctxs with a tuple of member
    `no_expand`s; a member ctx of None stays None."""
    def expand(x):
        return x.repeat_interleave(beam_size, dim=0) if x.dim() >= 1 else x

    if (isinstance(tree, tuple) and no_expand
            and all(isinstance(ne, (tuple, list)) for ne in no_expand)):
        # an ensemble: a tuple of member ctxs, each with its own no_expand
        return tuple(_expand_to_beams(t, beam_size, no_expand=ne)
                     for t, ne in zip(tree, no_expand))
    if isinstance(tree, dict) and no_expand:
        return {k: (v if k in no_expand else tree_map(expand, v))
                for k, v in tree.items()}
    return tree_map(expand, tree)


def _flat_topk(total_flat: torch.Tensor, k_rows: int, topn: int):
    """Per-image top-`topn` over `k_rows` beam rows of a flat `[B*K, V]`
    score matrix, equal to a top-k of `total.reshape(B, K*V)` including tie
    order (value desc, flat index asc): per-row top-k orders equal values
    by column ascending, and the stable merge over the row-major list
    resolves equal values across rows to the lower beam row. At most `topn`
    winners come from one row, so per-row top-`topn` is lossless.

    Returns (scores [B, topn] f32, flat indices [B, topn] in [0, K*V)).
    """
    rows, v = total_flat.shape
    batch = rows // k_rows
    rv, rc = row_topk(total_flat, topn)                       # [B*K, topn]
    rv2 = rv.reshape(batch, k_rows * topn)
    offs = torch.arange(k_rows, device=rc.device)[None, :, None] * v
    flat = (offs + rc.reshape(batch, k_rows, topn)).reshape(batch, -1)
    sel, m = sorted_topk(rv2, topn)                           # [B, topn]
    return sel, flat.gather(1, m)


def _reorder_write(buf, parent, value, t: int):
    """Reorder [B, K, T] `buf` by `parent` [B, K], then write `value` at t."""
    re = buf.gather(1, parent[..., None].expand(-1, -1, buf.shape[-1]))
    re[:, :, t] = value
    return re


def beam_search(
    step_fn: Callable,
    ctx,
    state0,
    *,
    beam_size: int,
    seq_length: int,
    bos_token: int = 0,
    eos_token: int = 0,
    group_size: int = 1,
    decoding_constraint: bool = False,
    suppress_unk: bool = True,
    max_ppl: bool = False,
    record_aux_from_state: Optional[Callable[[Any], torch.Tensor]] = None,
    ctx_no_expand: tuple = (),
) -> BeamResult:
    """Caption beam search.

    step_fn(ctx, state, it[B*K]) -> (logprobs [B*K, V], state). ctx/state0
    are per-example [B, ...] trees; they are expanded to beams here. ctx is
    never reordered; state is reordered by backpointers every step.
    """
    if group_size != 1:
        raise NotImplementedError(
            "diverse beam groups (group_size > 1) are not ported yet "
            "(ROADMAP A10)")
    K = beam_size
    T = seq_length

    batch = _first_leaf(state0).shape[0]
    dev = _first_leaf(state0).device
    ctx = (_expand_to_beams(ctx, K, no_expand=ctx_no_expand)
           if ctx is not None else None)
    state = _expand_to_beams(state0, K)

    f32 = dict(dtype=torch.float32, device=dev)
    i64 = dict(dtype=torch.int64, device=dev)
    cum = torch.zeros((batch, K), **f32)
    it = torch.full((batch, K), bos_token, **i64)
    seq_buf = torch.zeros((batch, K, T), **i64)
    logp_buf = torch.zeros((batch, K, T), **f32)
    aux_buf = torch.zeros((batch, K, T), **i64) if record_aux_from_state else None

    fin_rank = torch.full((batch, K), NEG_INF, **f32)
    fin_score = torch.full((batch, K), NEG_INF, **f32)
    fin_seq = torch.zeros((batch, K, T), **i64)
    fin_logp = torch.zeros((batch, K, T), **f32)
    fin_aux = torch.zeros((batch, K, T), **i64) if record_aux_from_state else None

    rows = torch.arange(batch * K, device=dev)
    # t=0: only beam 0 participates (all beams start equal)
    first_mask = torch.where(rows % K == 0, 0.0, NEG_INF).to(torch.float32)
    base = (torch.arange(batch, device=dev) * K)[:, None]

    def gather3(m, idx):
        return m.gather(1, idx[..., None].expand(-1, -1, m.shape[-1]))

    for t in range(T):
        # early exit once every live beam is a dead slot (one device read)
        if not bool((cum > DEAD + 1e-3).any()):
            break
        it_flat = it.reshape(batch * K)
        logprobs, new_state = step_fn(ctx, state, it_flat)
        V = logprobs.shape[-1]
        lp = logprobs.float().clone()                      # [B*K, V]
        aux_now = (record_aux_from_state(new_state).reshape(batch, K)
                   if record_aux_from_state else None)

        if suppress_unk:
            # UNK is the LAST vocab slot in the caption convention; part of
            # the unaugmented values
            lp[:, V - 1] -= 1000.0

        aug = lp
        if decoding_constraint and t > 0:
            aug = aug.clone()
            aug[rows, it_flat] += NEG_INF

        total = aug + cum.reshape(batch * K, 1)
        if t == 0:
            total = total + first_mask[:, None]

        sel_score, sel_idx = _flat_topk(total, K, K)          # [B, K]
        parent = sel_idx // V
        tok = sel_idx % V
        # a selected entry never carries the constraint's NEG_INF nor a
        # nonzero beam mask, so tok_unaug == sel_score - cum[parent]: the
        # JAX package's identity, kept so per-token logps match exactly
        tok_unaug = sel_score - cum.gather(1, parent)
        cum_g = sel_score

        seq_g = _reorder_write(seq_buf, parent, tok, t)
        logp_g = _reorder_write(logp_buf, parent, tok_unaug, t)

        is_eos = tok == eos_token
        finishing = is_eos | (t == T - 1)
        cand_score = torch.where(finishing, cum_g,
                                 torch.full_like(cum_g, NEG_INF))
        cand_rank = cand_score / float(t + 1) if max_ppl else cand_score

        merged_rank = torch.cat([fin_rank, cand_rank], 1)
        merged_score = torch.cat([fin_score, cand_score], 1)
        top_rank, top_idx = sorted_topk(merged_rank, K)
        fin_rank = top_rank
        fin_score = merged_score.gather(1, top_idx)
        fin_seq = gather3(torch.cat([fin_seq, seq_g], 1), top_idx)
        fin_logp = gather3(torch.cat([fin_logp, logp_g], 1), top_idx)
        if record_aux_from_state:
            aux_g = _reorder_write(aux_buf, parent, aux_now, t)
            fin_aux = gather3(torch.cat([fin_aux, aux_g], 1), top_idx)
            aux_buf = aux_g

        cum = torch.where(is_eos, torch.full_like(cum_g, DEAD), cum_g)
        gather_idx = (base + parent).reshape(batch * K)
        state = tree_map(lambda x: x.index_select(0, gather_idx), new_state)
        it = tok
        seq_buf, logp_buf = seq_g, logp_g

    return BeamResult(seq=fin_seq, logps=fin_logp, scores=fin_score,
                      aux=fin_aux)


def onmt_beam_search(
    step_fn: Callable,
    ctx,
    state0,
    *,
    beam_size: int,
    seq_length: int,
    bos_token: int,
    eos_token: int,
    ctx_no_expand: tuple = (),
    record_aux_from_state: Optional[Callable[[Any], torch.Tensor]] = None,
    lazy_state: tuple = (),
    ancestry_key: Optional[str] = None,
) -> BeamResult:
    """Beam search with the vendored OpenNMT's semantics:

    - rows that emit EOS are NOT dead-slotted: they stay in the beam and
      keep extending; hypotheses are cut at their first EOS at read-out;
    - a sentence finishes when EOS is at the TOP of its beam; finished
      sentences freeze;
    - at t=0 only row 0's scores participate;
    - the result rows are the final beam rows sorted by current score.

    lazy_state / ancestry_key: lazy beam caches (state must be a dict).
    The leaves under `lazy_state` keys are append-only: they are never
    reordered by parent or frozen, so a step may write them in place. The
    `ancestry_key` leaf, an int32 [batch, T'] placeholder in state0, is set
    here to each row's local beam index and updated every step as
    anc'[k, tau <= t] = anc[parent(k), tau], anc'[k, tau > t] = k: beam k's
    position-tau entry names the row that wrote it, and the step reads the
    lazy caches through it. Rows of frozen sentences keep their old anc.

    Every other state leaf is reordered with a copy (`index_select`) and a
    frozen sentence's rows keep the pre-step leaf, so a step must not write
    a non-lazy leaf in place.
    """
    K = beam_size
    T = seq_length
    batch = _first_leaf(state0).shape[0]
    dev = _first_leaf(state0).device
    ctx = (_expand_to_beams(ctx, K, no_expand=ctx_no_expand)
           if ctx is not None else None)
    state = _expand_to_beams(state0, K)
    local_row = (torch.arange(batch * K, device=dev) % K).to(torch.int32)
    if ancestry_key is not None:
        # each row starts as its own ancestor at every position
        state[ancestry_key] = local_row[:, None].expand(
            batch * K, state[ancestry_key].shape[-1]).contiguous()

    cum = torch.zeros((batch, K), dtype=torch.float32, device=dev)
    it = torch.full((batch, K), bos_token, dtype=torch.int64, device=dev)
    seq_buf = torch.zeros((batch, K, T), dtype=torch.int64, device=dev)
    logp_buf = torch.zeros((batch, K, T), dtype=torch.float32, device=dev)
    aux_buf = (torch.zeros((batch, K, T), dtype=torch.int64, device=dev)
               if record_aux_from_state else None)
    done = torch.zeros((batch,), dtype=torch.bool, device=dev)

    rows = torch.arange(batch * K, device=dev)
    first_mask = torch.where(rows % K == 0, 0.0, NEG_INF).to(torch.float32)
    base = (torch.arange(batch, device=dev) * K)[:, None]

    for t in range(T):
        if bool(done.all()):                              # one device read
            break
        lp, new_state = step_fn(ctx, state, it.reshape(batch * K))
        V = lp.shape[-1]
        lp = lp.float()
        aux_now = (record_aux_from_state(new_state).reshape(batch, K)
                   if record_aux_from_state else None)

        total = lp + cum.reshape(batch * K, 1)
        if t == 0:
            total = total + first_mask[:, None]

        sel_score, sel_idx = _flat_topk(total, K, K)
        parent = sel_idx // V
        tok = sel_idx % V
        # the beam mask is exactly 0.0 on any selectable entry, so
        # tok_lp == sel_score - cum[parent]
        tok_lp = sel_score - cum.gather(1, parent)

        new_seq = _reorder_write(seq_buf, parent, tok, t)
        new_logp = _reorder_write(logp_buf, parent, tok_lp, t)
        new_aux = (_reorder_write(aux_buf, parent, aux_now.gather(1, parent), t)
                   if record_aux_from_state else None)

        frz = done[:, None]
        cum = torch.where(frz, cum, sel_score)
        it = torch.where(frz, it, tok)
        seq_buf = torch.where(frz[..., None], seq_buf, new_seq)
        logp_buf = torch.where(frz[..., None], logp_buf, new_logp)
        if record_aux_from_state:
            aux_buf = torch.where(frz[..., None], aux_buf, new_aux)

        # frozen sentences keep stepping but their rows are never read again
        gather_idx = (base + parent).reshape(batch * K)
        frz_rows = done.repeat_interleave(K)

        def reorder_leaf(new_leaf, old_leaf):
            re = new_leaf.index_select(0, gather_idx)
            mask = frz_rows.reshape((batch * K,) + (1,) * (re.dim() - 1))
            return torch.where(mask, old_leaf, re)

        if lazy_state or ancestry_key is not None:
            state_next = {}
            for key, new_leaf in new_state.items():
                if key in lazy_state:
                    # append-only: frozen sentences' writes land in rows
                    # that nothing reads through anc again
                    state_next[key] = new_leaf
                elif key == ancestry_key:
                    re = new_leaf.index_select(0, gather_idx)
                    pos = torch.arange(new_leaf.shape[-1], device=dev)
                    upd = torch.where(pos[None, :] <= t, re,
                                      local_row[:, None])
                    state_next[key] = torch.where(frz_rows[:, None],
                                                  state[key], upd)
                else:
                    state_next[key] = tree_map(reorder_leaf, new_leaf,
                                               state[key])
            state = state_next
        else:
            state = tree_map(reorder_leaf, new_state, state)
        # EOS at top-of-beam finishes the sentence
        done = done | (tok[:, 0] == eos_token)

    return BeamResult(seq=seq_buf, logps=logp_buf, scores=cum, aux=aux_buf)
