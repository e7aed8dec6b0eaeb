"""SPICE — semantic propositional F-score (documented stand-in).

The port's copy of `unpaired_image_captioning_tpu/eval/metrics/spice.py`,
host code copied as it is.

The reference's SPICE (coco-caption/pycocoevalcap/spice) shells out to a
Java jar that runs the Stanford scene-graph parser; the jar is absent from
the reference tree (stripped blobs), so exact parity is unobtainable by
construction. This implementation keeps SPICE's *scoring* structure — an
F1 over semantic-proposition tuple sets, with candidate tuples matched
against the union over references — but builds the tuples with rule-based
extraction instead of a learned parser:

- objects: content words (stoplist-filtered);
- attributes: (adjective-ish word, following object) bigram pairs;
- relations: (object, connective, object) triples around prepositions.

Scores correlate with tuple overlap like SPICE but are NOT comparable to
jar-produced numbers; the class is provided so eval pipelines expecting the
full coco-caption scorer set keep working.
"""

from __future__ import annotations

from typing import Dict, List, Set, Tuple

STOPWORDS = {
    "a", "an", "the", "is", "are", "was", "were", "be", "been", "being",
    "of", "to", "and", "or", "as", "at", "by", "for", "in", "on", "with",
    "that", "this", "these", "those", "there", "it", "its", "his", "her",
    "their", "some", "very", "up", "down", "out", "into", "from", "over",
}
PREPOSITIONS = {"in", "on", "at", "with", "by", "near", "under", "over",
                "behind", "beside", "above", "below", "into", "through"}
ATTRIBUTE_SUFFIXES = ("y", "ful", "ous", "ish", "ive", "al", "ed", "ing",
                      "less", "able")


def _tuples(caption: str) -> Set[Tuple[str, ...]]:
    toks = caption.lower().split()
    content = [t for t in toks if t not in STOPWORDS]
    out: Set[Tuple[str, ...]] = set()
    for t in content:
        out.add((t,))
    # attribute pairs: word directly preceding a content word
    for i in range(len(toks) - 1):
        a, b = toks[i], toks[i + 1]
        if (b not in STOPWORDS and a not in STOPWORDS and a != b
                and a.endswith(ATTRIBUTE_SUFFIXES)):
            out.add((b, a))
    # relations around prepositions: (left object, prep, right object)
    for i, t in enumerate(toks):
        if t in PREPOSITIONS:
            left = next((x for x in reversed(toks[:i]) if x not in STOPWORDS),
                        None)
            right = next((x for x in toks[i + 1:] if x not in STOPWORDS),
                         None)
            if left and right:
                out.add((left, t, right))
    return out


def spice_score(candidate: str, refs: List[str]) -> float:
    cand = _tuples(candidate)
    ref: Set[Tuple[str, ...]] = set()
    for r in refs:
        ref |= _tuples(r)
    if not cand or not ref:
        return 0.0
    matched = len(cand & ref)
    p = matched / len(cand)
    r = matched / len(ref)
    return 2 * p * r / (p + r) if (p + r) else 0.0


class Spice:
    def compute_score(self, gts: Dict, res: Dict) -> Tuple[float, List[float]]:
        ids = sorted(gts.keys())
        scores = [spice_score(res[i][0], gts[i]) for i in ids]
        return sum(scores) / max(len(scores), 1), scores

    def method(self):
        return "SPICE"
