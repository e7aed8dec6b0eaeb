"""ROUGE-L scorer.

The port's copy of `unpaired_image_captioning_tpu/eval/metrics/rouge.py`,
host code copied as it is.

Value parity with `coco-caption/pycocoevalcap/rouge/rouge.py` (verified to
1e-9 in tests/test_metric_value_parity.py): LCS-based F with beta=1.2 where
precision and recall are EACH maximized independently over the references
(rouge.py:68-69) before combining — not max-F-per-reference.
"""

from __future__ import annotations

from typing import Dict, List, Tuple


def _lcs_len(a: List[str], b: List[str]) -> int:
    if not a or not b:
        return 0
    # O(len(a)*len(b)) DP with two rows
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0]
        for j, y in enumerate(b, 1):
            cur.append(prev[j - 1] + 1 if x == y else max(prev[j], cur[j - 1]))
        prev = cur
    return prev[-1]


class Rouge:
    def __init__(self, beta: float = 1.2):
        self.beta = beta

    def calc_score(self, candidate: List[str], refs: List[str]) -> float:
        # split(" ") (not split()) so the empty string counts 1 token,
        # exactly like the reference (rouge.py:57-65)
        hyp = candidate[0].split(" ")
        prec, rec = [], []
        for ref in refs:
            r = ref.split(" ")
            lcs = _lcs_len(hyp, r)
            prec.append(lcs / float(len(hyp)))
            rec.append(lcs / float(len(r)))
        prec_max, rec_max = max(prec), max(rec)
        if prec_max != 0 and rec_max != 0:
            return ((1 + self.beta ** 2) * prec_max * rec_max
                    / float(rec_max + self.beta ** 2 * prec_max))
        return 0.0

    def compute_score(self, gts: Dict, res: Dict) -> Tuple[float, List[float]]:
        ids = sorted(gts.keys())
        scores = [self.calc_score(res[i], gts[i]) for i in ids]
        return sum(scores) / max(len(scores), 1), scores

    def method(self):
        return "Rouge"
