"""Byte-pair encoding: learn + apply (the port's copy of
`unpaired_image_captioning_tpu/utils/bpe.py`).

Parity role: the reference vendors rsennrich/subword-nmt
(misc/OpenNMT-py-dalegebit/subword-nmt/, "not wired into main path",
SURVEY.md §2.8) for BPE preprocessing of NMT corpora. Same algorithm:
word-internal merges learned by pair frequency, `</w>` end-of-word marker,
apply by replaying merges in learned order; codes file format compatible
(`pair_left pair_right` per line after a version header).
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, Iterable, List, Tuple

EOW = "</w>"


def learn_bpe(corpus: Iterable[str], num_merges: int = 1000,
              min_frequency: int = 2) -> List[Tuple[str, str]]:
    """Learn merge operations from whitespace-tokenized lines."""
    vocab: Counter = Counter()
    for line in corpus:
        for w in line.split():
            vocab[tuple(w[:-1]) + (w[-1] + EOW,)] += 1

    merges: List[Tuple[str, str]] = []
    for _ in range(num_merges):
        pairs: Counter = Counter()
        for word, freq in vocab.items():
            for i in range(len(word) - 1):
                pairs[(word[i], word[i + 1])] += freq
        if not pairs:
            break
        best, freq = pairs.most_common(1)[0]
        if freq < min_frequency:
            break
        merges.append(best)
        merged = best[0] + best[1]
        new_vocab: Counter = Counter()
        for word, f in vocab.items():
            out = []
            i = 0
            while i < len(word):
                if (i + 1 < len(word) and word[i] == best[0]
                        and word[i + 1] == best[1]):
                    out.append(merged)
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            new_vocab[tuple(out)] += f
        vocab = new_vocab
    return merges


def save_codes(merges: List[Tuple[str, str]], path: str) -> None:
    with open(path, "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n")
        for a, b in merges:
            f.write(f"{a} {b}\n")


def load_codes(path: str) -> List[Tuple[str, str]]:
    merges = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            if line.startswith("#"):
                continue
            parts = line.rstrip("\n").split(" ")
            if len(parts) == 2:
                merges.append((parts[0], parts[1]))
    return merges


class BPE:
    def __init__(self, merges: List[Tuple[str, str]],
                 separator: str = "@@"):
        self.ranks: Dict[Tuple[str, str], int] = {
            m: i for i, m in enumerate(merges)}
        self.separator = separator
        self._cache: Dict[str, List[str]] = {}

    def segment_word(self, word: str) -> List[str]:
        if word in self._cache:
            return self._cache[word]
        pieces = list(word[:-1]) + [word[-1] + EOW]
        while len(pieces) > 1:
            best_rank = None
            best_i = -1
            for i in range(len(pieces) - 1):
                r = self.ranks.get((pieces[i], pieces[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank = r
                    best_i = i
            if best_rank is None:
                break
            pieces[best_i: best_i + 2] = [pieces[best_i] + pieces[best_i + 1]]
        out = []
        for i, p in enumerate(pieces):
            p = p[: -len(EOW)] if p.endswith(EOW) else p + self.separator
            if p:
                out.append(p)
        self._cache[word] = out
        return out

    def segment(self, line: str) -> str:
        return " ".join(t for w in line.split() for t in self.segment_word(w))

    @staticmethod
    def decode(line: str, separator: str = "@@") -> str:
        return line.replace(separator + " ", "")
