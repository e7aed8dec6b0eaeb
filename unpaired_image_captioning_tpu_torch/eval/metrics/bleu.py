"""BLEU: COCO-caption-style corpus BLEU-1..4.

The port's copy of `unpaired_image_captioning_tpu/eval/metrics/bleu.py`,
host code copied as it is.

Behavioral parity with `coco-caption/pycocoevalcap/bleu/bleu_scorer.py`
(Chin-Yew Lin's "closest reference length" corpus BLEU with the COCO
`option='closest'` and the small-ratio smoothing on per-image scores):

- corpus level: clipped n-gram precision with the reference's exact
  `(correct + tiny) / (guess + small)` arithmetic, brevity penalty applied
  when Σ testlen < Σ closest-ref-len (bleu_scorer.py:248-256);
- per-image scores use the same tiny/small-smoothed running product and the
  per-sentence ratio penalty (bleu_scorer.py:230-239).
Value-identical to the reference scorer (1e-9):
tests/test_metric_value_parity.py.

Also exposes `sentence_bleu` (used by SelfBleu, misc/cal_self_bleu.py) and
`corpus_bleu` in multi-bleu.perl style (used by the NMT eval wrapper,
misc/OpenNMT-py-dalegebit/evaluation.py:29-48).
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Dict, List, Sequence, Tuple


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


def _clip_counts(hyp: Sequence[str], refs: List[Sequence[str]], n: int):
    h = _ngrams(hyp, n)
    if not h:
        return 0, 0
    r: Counter = Counter()
    for ref in refs:
        for k, v in _ngrams(ref, n).items():
            r[k] = max(r[k], v)
    clipped = sum(min(v, r.get(k, 0)) for k, v in h.items())
    return clipped, sum(h.values())


def _closest_ref_len(hyp_len: int, ref_lens: List[int]) -> int:
    return min(ref_lens, key=lambda rl: (abs(rl - hyp_len), rl))


class Bleu:
    """COCO-caption API: compute_score(gts, res) -> (list of 4 floats,
    list of 4 per-image lists)."""

    def __init__(self, n: int = 4):
        self.n = n

    def compute_score(self, gts: Dict, res: Dict) -> Tuple[List[float], List[List[float]]]:
        assert sorted(gts.keys()) == sorted(res.keys())
        ids = sorted(gts.keys())
        n = self.n
        small = 1e-9   # bleu_scorer.py:200-201
        tiny = 1e-15

        tot_guess = [0] * n
        tot_correct = [0] * n
        tot_testlen = 0
        tot_reflen = 0
        per_image: List[List[float]] = [[] for _ in range(n)]

        for iid in ids:
            hyp = res[iid][0].split()
            refs = [r.split() for r in gts[iid]]
            testlen = len(hyp)
            # guess[k] = number of (k+1)-gram slots (bleu_scorer.py:77)
            guess = [max(0, testlen - k) for k in range(n)]
            maxcounts: Counter = Counter()
            for ref in refs:
                for k in range(n):
                    for ng, v in _ngrams(ref, k + 1).items():
                        if v > maxcounts[ng]:
                            maxcounts[ng] = v
            correct = [0] * n
            for k in range(n):
                for ng, c in _ngrams(hyp, k + 1).items():
                    correct[k] += min(maxcounts.get(ng, 0), c)
            reflen = _closest_ref_len(testlen, [len(r) for r in refs])
            tot_testlen += testlen
            tot_reflen += reflen
            # per-image running product (bleu_scorer.py:230-239)
            bleu = 1.0
            for k in range(n):
                tot_guess[k] += guess[k]
                tot_correct[k] += correct[k]
                bleu *= (correct[k] + tiny) / (guess[k] + small)
                per_image[k].append(bleu ** (1.0 / (k + 1)))
            ratio = (testlen + tiny) / (reflen + small)
            if ratio < 1:
                for k in range(n):
                    per_image[k][-1] *= math.exp(1 - 1 / ratio)

        # corpus score (bleu_scorer.py:247-256)
        scores = []
        bleu = 1.0
        for k in range(n):
            bleu *= (tot_correct[k] + tiny) / (tot_guess[k] + small)
            scores.append(bleu ** (1.0 / (k + 1)))
        ratio = (tot_testlen + tiny) / (tot_reflen + small)
        if ratio < 1:
            for k in range(n):
                scores[k] *= math.exp(1 - 1 / ratio)
        return scores, per_image

    def method(self):
        return "Bleu"


def sentence_bleu(hyp: Sequence[str], refs: List[Sequence[str]], n: int = 4,
                  smooth: float = 1.0) -> float:
    """Smoothed sentence BLEU (SelfBleu parity, misc/utils.py:85-103 uses
    nltk method1-style smoothing: +eps on zero counts)."""
    if not hyp:
        return 0.0
    logsum = 0.0
    for k in range(1, n + 1):
        c, t = _clip_counts(hyp, refs, k)
        if t == 0:
            return 0.0
        p = c / t if c > 0 else smooth / t
        logsum += math.log(p)
    rl = _closest_ref_len(len(hyp), [len(r) for r in refs])
    bp = 1.0 if len(hyp) >= rl else math.exp(1 - rl / len(hyp))
    return bp * math.exp(logsum / n)


def corpus_bleu(hyps: List[Sequence[str]], refs_list: List[List[Sequence[str]]],
                n: int = 4) -> Tuple[float, List[float]]:
    """multi-bleu.perl-style corpus BLEU. Returns (bleu, [p_1..p_n])."""
    tiny = 1e-15
    clipped = [0] * n
    total = [0] * n
    hyp_len = 0
    ref_len = 0
    for hyp, refs in zip(hyps, refs_list):
        for k in range(1, n + 1):
            c, t = _clip_counts(hyp, refs, k)
            clipped[k - 1] += c
            total[k - 1] += t
        hyp_len += len(hyp)
        ref_len += _closest_ref_len(len(hyp), [len(r) for r in refs])
    precisions = [clipped[k] / (total[k] + tiny) for k in range(n)]
    if min(precisions) <= 0:
        return 0.0, precisions
    bp = 1.0 if hyp_len > ref_len else math.exp(1 - ref_len / max(hyp_len, 1))
    bleu = bp * math.exp(sum(math.log(p) for p in precisions) / n)
    return bleu, precisions
