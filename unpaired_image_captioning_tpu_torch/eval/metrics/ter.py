"""TER — Translation Edit Rate.

The port's copy of `unpaired_image_captioning_tpu/eval/metrics/ter.py`,
host code copied as it is.

Parity: reference NMT evaluation wrapper scores corpus BLEU **and TER**
(`misc/OpenNMT-py-dalegebit/evaluation.py:29-48`, mteval/tercom path,
SURVEY.md §2.9 perl row). TER = edits / reference_length where edits are
insertions, deletions, substitutions, and phrase shifts. This implements
the standard greedy-shift TER algorithm (Snover et al. 2006): repeatedly
apply the single shift that most reduces edit distance, then add 1 per
shift.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple


def _edit_distance(a: Sequence[str], b: Sequence[str]) -> int:
    if not a:
        return len(b)
    prev = list(range(len(b) + 1))
    for i, x in enumerate(a, 1):
        cur = [i]
        for j, y in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                           prev[j - 1] + (x != y)))
        prev = cur
    return prev[-1]


def _best_shift(hyp: List[str], ref: List[str], base: int
                ) -> Tuple[int, List[str]]:
    """Try all single block shifts; return (new_cost, new_hyp) of the best
    improving shift, else (base, hyp)."""
    best = base
    best_hyp = hyp
    n = len(hyp)
    for start in range(n):
        for length in range(1, min(n - start, 10) + 1):
            block = hyp[start: start + length]
            # only shift blocks that appear somewhere in the reference
            found = any(ref[i: i + length] == block
                        for i in range(len(ref) - length + 1))
            if not found:
                continue
            rest = hyp[:start] + hyp[start + length:]
            for pos in range(len(rest) + 1):
                if pos == start:
                    continue
                cand = rest[:pos] + block + rest[pos:]
                c = _edit_distance(cand, ref)
                if c < best:
                    best = c
                    best_hyp = cand
    return best, best_hyp


def ter(hyp: Sequence[str], refs: List[Sequence[str]],
        max_shifts: int = 10) -> float:
    """TER against the best (lowest-TER) reference."""
    hyp = list(hyp)
    best_score = float("inf")
    for ref in refs:
        ref = list(ref)
        if not ref:
            continue
        cur = hyp
        shifts = 0
        cost = _edit_distance(cur, ref)
        while shifts < max_shifts:
            new_cost, new_hyp = _best_shift(cur, ref, cost)
            if new_cost >= cost:
                break
            cost = new_cost
            cur = new_hyp
            shifts += 1
        score = (cost + shifts) / len(ref)
        best_score = min(best_score, score)
    return best_score if best_score != float("inf") else 1.0


def corpus_ter(hyps: List[Sequence[str]],
               refs_list: List[List[Sequence[str]]]) -> float:
    total_edits = 0.0
    total_len = 0
    for hyp, refs in zip(hyps, refs_list):
        refs = [list(r) for r in refs if r]
        if not refs:
            continue
        # corpus TER: sum of per-sentence best edits over sum ref lengths
        best = None
        for ref in refs:
            cur = list(hyp)
            shifts = 0
            cost = _edit_distance(cur, ref)
            while shifts < 10:
                nc, nh = _best_shift(cur, ref, cost)
                if nc >= cost:
                    break
                cost, cur = nc, nh
                shifts += 1
            e = cost + shifts
            if best is None or e / len(ref) < best[0] / best[1]:
                best = (e, len(ref))
        total_edits += best[0]
        total_len += best[1]
    return total_edits / max(total_len, 1)


class Ter:
    """compute_score API shape (lower is better)."""

    def compute_score(self, gts: Dict, res: Dict) -> Tuple[float, List[float]]:
        ids = sorted(gts.keys())
        scores = [ter(res[i][0].split(), [r.split() for r in gts[i]])
                  for i in ids]
        return sum(scores) / max(len(scores), 1), scores

    def method(self):
        return "TER"
