"""CIDEr / CIDEr-D host-side scorers.

The port's copy of `unpaired_image_captioning_tpu/eval/metrics/cider.py`,
host code copied as it is.

Behavioral parity with the reference's vendored
`misc/cider/pyciderevalcap/ciderD/ciderD_scorer.py:116-197` (tf-idf n-gram
cosine with gaussian length penalty, ×10 scaling) and
`coco-caption/pycocoevalcap/cider/cider_scorer.py` (plain CIDEr).

Supports a precomputed document-frequency table (the `prepro_ngrams` output,
SURVEY.md §2.6) for SCST (`df='corpus'` computes df from the gts instead).
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, List, Optional, Tuple


def precook(s: str, n: int = 4) -> Counter:
    words = s.split()
    counts: Counter = Counter()
    for k in range(1, n + 1):
        for i in range(len(words) - k + 1):
            counts[tuple(words[i:i + k])] += 1
    return counts


def compute_doc_freq(crefs: List[List[Counter]]) -> Dict[tuple, float]:
    df: Dict[tuple, float] = defaultdict(float)
    for refs in crefs:
        seen = set(ng for ref in refs for ng in ref)
        for ng in seen:
            df[ng] += 1
    return df


class CiderBase:
    LENGTH_PENALTY = True  # CIDEr-D: gaussian length penalty on every n

    def __init__(self, n: int = 4, sigma: float = 6.0,
                 df: Optional[Dict[tuple, float]] = None,
                 ref_len: Optional[float] = None):
        self.n = n
        self.sigma = sigma
        self.df = df          # precomputed document frequencies (SCST path)
        self.ref_len = ref_len  # log(#docs) matching the df table

    def _counts2vec(self, cnts: Counter, df, ref_len):
        vec = [defaultdict(float) for _ in range(self.n)]
        norm = [0.0] * self.n
        length = 0
        for ngram, tf in cnts.items():
            d = math.log(max(1.0, df.get(ngram, 0.0)))
            k = len(ngram) - 1
            vec[k][ngram] = tf * (ref_len - d)
            norm[k] += vec[k][ngram] ** 2
            if k == 1:
                length += tf
        return vec, [math.sqrt(x) for x in norm], length

    def _sim(self, vec_h, vec_r, norm_h, norm_r, len_h, len_r, clip_tf: bool):
        delta = float(len_h - len_r)
        val = [0.0] * self.n
        for k in range(self.n):
            for ngram, v in vec_h[k].items():
                w = min(v, vec_r[k][ngram]) if clip_tf else v
                val[k] += w * vec_r[k][ngram]
            if norm_h[k] != 0 and norm_r[k] != 0:
                val[k] /= norm_h[k] * norm_r[k]
            if self.LENGTH_PENALTY:
                val[k] *= math.exp(-delta ** 2 / (2 * self.sigma ** 2))
        return val

    def _score(self, gts: Dict, res: Dict, clip_tf: bool) -> Tuple[float, List[float]]:
        ids = sorted(gts.keys())
        ctest = [precook(res[i][0], self.n) for i in ids]
        crefs = [[precook(r, self.n) for r in gts[i]] for i in ids]
        if self.df is None:
            df = compute_doc_freq(crefs)
            ref_len = math.log(float(len(crefs)))
        else:
            df = self.df
            ref_len = self.ref_len if self.ref_len is not None else math.log(
                max(2.0, float(len(crefs))))
        scores = []
        for test, refs in zip(ctest, crefs):
            vec_h, norm_h, len_h = self._counts2vec(test, df, ref_len)
            score = [0.0] * self.n
            for ref in refs:
                vec_r, norm_r, len_r = self._counts2vec(ref, df, ref_len)
                v = self._sim(vec_h, vec_r, norm_h, norm_r, len_h, len_r, clip_tf)
                for k in range(self.n):
                    score[k] += v[k]
            avg = sum(score) / self.n / len(refs)
            scores.append(avg * 10.0)
        mean = sum(scores) / max(len(scores), 1)
        return mean, scores


class CiderD(CiderBase):
    """CIDEr-D: tf clipping + gaussian length penalty (SCST reward)."""

    def compute_score(self, gts: Dict, res: Dict) -> Tuple[float, List[float]]:
        return self._score(gts, res, clip_tf=True)

    def method(self):
        return "CIDEr-D"


class Cider(CiderBase):
    """CIDEr as the coco-caption eval stack computes it. The vendored
    cider_scorer.py carries the same "vrama91" amendments as CIDEr-D —
    tf clipping (cider_scorer.py:151) AND the gaussian length penalty
    (:158) — so the corpus-df scoring math is IDENTICAL to CiderD; only the
    df source differs (CiderD can take a precomputed table). Value parity
    vs the reference scorer: tests/test_metric_value_parity.py."""

    def compute_score(self, gts: Dict, res: Dict) -> Tuple[float, List[float]]:
        return self._score(gts, res, clip_tf=True)

    def method(self):
        return "CIDEr"
