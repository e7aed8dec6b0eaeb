"""METEOR scorer (self-contained reimplementation).

The port's copy of `unpaired_image_captioning_tpu/eval/metrics/meteor.py`,
host code copied as it is.

The reference shells out to the METEOR-1.5 Java jar through a persistent
pipe (`coco-caption/pycocoevalcap/meteor/meteor.py:18-24`); the jar and its
paraphrase tables are stripped from the repo (.MISSING_LARGE_BLOBS:3-5), so
metric parity there is unobtainable by construction. This implementation
follows the METEOR algorithm (Denkowski & Lavie 2014) with all four matcher
stages: `exact`, `stem` (full Porter stemmer, eval/metrics/porter.py),
`synonym`, and `paraphrase`. The synonym/paraphrase stages are data-driven —
the jar's WordNet synsets and paraphrase-db are among the stripped blobs, so
by DEFAULT a small curated caption-domain table ships in meteor_data.py
(stages exercised out of the box; pass Meteor(synonyms={}, paraphrases={})
for exact+stem-only behavior) and the load_* file readers accept the trivial
text conversions of METEOR-1.5's full data files when available.

Expected delta vs the jar: with the mini tables, scores sit between
exact+stem METEOR (which underscores vs the 0.417 METEOR baseline row by
missing WordNet matches) and full-WordNet METEOR; on caption-domain text the
residual gap comes from WordNet synsets absent from the mini table and the
jar's beam-searched alignment (ours is greedy staged, left-to-right):

  P = m/|hyp|, R = m/|ref|, F_mean = P*R/(alpha*P + (1-alpha)*R)
  penalty = gamma * (chunks/m)^beta;  score = F_mean * (1 - penalty)

with METEOR-en defaults alpha=0.85 (approx: en task 'rank' uses 0.85? the
1.5 release default for `rank` is alpha=0.85, beta=0.2 is not standard —
we use the universal defaults alpha=0.9, beta=3.0, gamma=0.5 of the
original METEOR paper, which the coco jar also reports for en).
Alignment: left-to-right greedy maximal matching minimizing chunks, best
reference taken per image (jar behavior for multi-ref).
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

from .porter import porter_stem

ALPHA, BETA, GAMMA = 0.9, 3.0, 0.5


def build_synonym_groups(groups) -> Dict[str, frozenset]:
    """groups: iterable of synsets (iterables of words) -> word->group-ids.
    Two words match in the synonym stage iff they share a group."""
    table: Dict[str, set] = {}
    for gid, words in enumerate(groups):
        for w in words:
            table.setdefault(w.lower(), set()).add(gid)
    return {w: frozenset(g) for w, g in table.items()}


def load_synonyms(path: str) -> Dict[str, frozenset]:
    """One synset per line, space-separated words (the flattened form of
    METEOR's data/synonym files)."""
    with open(path, encoding="utf-8") as f:
        return build_synonym_groups(line.split() for line in f if line.strip())


def build_paraphrase_table(pairs) -> Dict[Tuple[str, ...], set]:
    """pairs: iterable of (phrase_a, phrase_b) strings or token tuples.
    Stored symmetrically: phrase -> set of equivalent phrases."""
    table: Dict[Tuple[str, ...], set] = {}

    def key(p):
        return tuple(p.lower().split()) if isinstance(p, str) else tuple(p)

    for a, b in pairs:
        ka, kb = key(a), key(b)
        table.setdefault(ka, set()).add(kb)
        table.setdefault(kb, set()).add(ka)
    return table


def load_paraphrases(path: str) -> Dict[Tuple[str, ...], set]:
    """TSV: phrase_a<TAB>phrase_b per line (the flattened form of the
    METEOR paraphrase-db)."""
    with open(path, encoding="utf-8") as f:
        return build_paraphrase_table(
            tuple(line.rstrip("\n").split("\t")[:2])
            for line in f if "\t" in line)


def _align(hyp: List[str], ref: List[str], synonyms=None, paraphrases=None
           ) -> Tuple[int, int, int]:
    """Greedy staged alignment (exact, stem, synonym, paraphrase).

    Returns (m_h, m_r, chunks): words matched on the hypothesis/reference
    side (they differ only for unequal-length paraphrase spans) and the
    chunk count of the alignment."""
    used_ref = [False] * len(ref)
    match_of = [-1] * len(hyp)
    # stage 1: exact
    for i, w in enumerate(hyp):
        for j, r in enumerate(ref):
            if not used_ref[j] and w == r:
                used_ref[j] = True
                match_of[i] = j
                break
    # stage 2: stem (full Porter)
    hs = [porter_stem(w) for w in hyp]
    rs = [porter_stem(r) for r in ref]
    for i, w in enumerate(hs):
        if match_of[i] >= 0:
            continue
        for j, r in enumerate(rs):
            if not used_ref[j] and w == r:
                used_ref[j] = True
                match_of[i] = j
                break
    # stage 3: synonym (shared synset group)
    if synonyms:
        for i, w in enumerate(hyp):
            if match_of[i] >= 0:
                continue
            gw = synonyms.get(w)
            if not gw:
                continue
            for j, r in enumerate(ref):
                if used_ref[j]:
                    continue
                gr = synonyms.get(r)
                if gr and (gw & gr):
                    used_ref[j] = True
                    match_of[i] = j
                    break
    extra_h = extra_r = 0
    extra_chunks = 0
    # stage 4: paraphrase (multi-word spans over still-unmatched words;
    # longest hypothesis span first, greedy like the word stages). Unlike
    # the jar's joint beam search over alignments, spans containing words
    # already claimed by an earlier stage are not reconsidered — table
    # entries should therefore be minimal phrases.
    if paraphrases:
        max_len = max(len(k) for k in paraphrases)
        used_hyp = [j >= 0 for j in match_of]
        for n in range(min(max_len, len(hyp)), 0, -1):
            for i in range(0, len(hyp) - n + 1):
                if any(used_hyp[i: i + n]):
                    continue
                cands = paraphrases.get(tuple(hyp[i: i + n]))
                if not cands:
                    continue
                hit = None
                for m in range(min(max_len, len(ref)), 0, -1):
                    for j in range(0, len(ref) - m + 1):
                        if any(used_ref[j: j + m]):
                            continue
                        if tuple(ref[j: j + m]) in cands:
                            hit = (j, m)
                            break
                    if hit:
                        break
                if hit:
                    j, m = hit
                    for k in range(i, i + n):
                        used_hyp[k] = True
                    for k in range(j, j + m):
                        used_ref[k] = True
                    # a phrase match is one contiguous chunk on both sides
                    extra_h += n
                    extra_r += m
                    extra_chunks += 1
    m_word = sum(1 for j in match_of if j >= 0)
    # chunk count: maximal runs of adjacent-in-both matches
    chunks = 0
    prev = None
    for j in match_of:
        if j >= 0:
            if prev is None or j != prev + 1:
                chunks += 1
            prev = j
        else:
            prev = None
    return m_word + extra_h, m_word + extra_r, chunks + extra_chunks


def _score_from_stats(m_h, m_r, chunks, len_h, len_r) -> float:
    if m_h == 0 or m_r == 0 or len_h == 0 or len_r == 0:
        return 0.0
    p = min(m_h / len_h, 1.0)
    rec = min(m_r / len_r, 1.0)
    fmean = p * rec / (ALPHA * p + (1 - ALPHA) * rec)
    frag = chunks / ((m_h + m_r) / 2.0)
    penalty = GAMMA * (min(frag, 1.0) ** BETA)
    return fmean * (1.0 - penalty)


def meteor_stats(hyp: str, refs: List[str], synonyms=None, paraphrases=None):
    """Best-reference alignment statistics (m_h, m_r, chunks, len_h, len_r)
    for one segment — the quantity METEOR accumulates for its corpus-level
    ('final') score."""
    h = _norm(hyp)
    best = (0, 0, 0, max(len(h), 1), 1)
    best_score = -1.0
    for ref in refs:
        r = _norm(ref)
        if not h or not r:
            continue
        m_h, m_r, chunks = _align(h, r, synonyms, paraphrases)
        s = _score_from_stats(m_h, m_r, chunks, len(h), len(r))
        if s > best_score:
            best_score = s
            best = (m_h, m_r, chunks, len(h), len(r))
    return best


def meteor_score(hyp: str, refs: List[str], synonyms=None,
                 paraphrases=None) -> float:
    return _score_from_stats(*meteor_stats(hyp, refs, synonyms, paraphrases))


def _norm(s: str) -> List[str]:
    return re.sub(r"\s+", " ", s.lower().strip()).split()


class Meteor:
    def __init__(self, synonyms=None, paraphrases=None):
        """synonyms: word->frozenset group-id table (build_synonym_groups /
        load_synonyms); paraphrases: phrase->set table (build_paraphrase_table
        / load_paraphrases). Default None loads the bundled mini tables
        (meteor_data.py); pass {} to disable a stage."""
        if synonyms is None or paraphrases is None:
            from . import meteor_data
            if synonyms is None:
                synonyms = build_synonym_groups(meteor_data.SYNONYM_GROUPS)
            if paraphrases is None:
                paraphrases = build_paraphrase_table(
                    meteor_data.PARAPHRASE_PAIRS)
        self.synonyms = synonyms
        self.paraphrases = paraphrases

    def compute_score(self, gts: Dict, res: Dict) -> Tuple[float, List[float]]:
        """Corpus score from ACCUMULATED best-alignment statistics, per-image
        scores from each segment's own stats — the jar's aggregation (its
        'final' score is NOT the mean of segment scores: the reference's
        checked-in denseatt artifact shows overall METEOR 0.417 vs per-image
        mean 0.445; tests/test_golden_format.py pins this relationship)."""
        ids = sorted(gts.keys())
        scores = []
        agg = [0, 0, 0, 0, 0]
        for i in ids:
            st = meteor_stats(res[i][0], gts[i], self.synonyms,
                              self.paraphrases)
            scores.append(_score_from_stats(*st))
            for j in range(5):
                agg[j] += st[j]
        return _score_from_stats(*agg), scores

    def method(self):
        return "METEOR"
