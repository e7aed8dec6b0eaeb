"""Vocabulary containers (the port's copy of
`unpaired_image_captioning_tpu/vocab.py`).

Two kinds, mirroring the reference's two id conventions:

- :class:`Dict` — OpenNMT-style label<->index table with frequency counting,
  pruning, specials, and cross-vocab :meth:`align` (behavioral parity with
  reference ``misc/OpenNMT-py-dalegebit/onmt/Dict.py:6-147``; used by copy
  attention and the Weight_Trans pivot losses).

- :class:`CaptionVocab` — the caption-side ``{ix: word}`` table produced by
  ``scripts/prepro_labels.py`` in the reference: ids 1..V, 0 = pad/eos, UNK
  is the last slot.

Pure Python / numpy — vocab work is host-side; ids become device tensors
only after batching.
"""

from __future__ import annotations

import json
from typing import Dict as TDict, Iterable, List, Optional, Sequence

import numpy as np

from . import constants as C


class Dict:
    """OpenNMT-style vocabulary (parity: onmt/Dict.py:6-147)."""

    def __init__(self, data: Optional[Sequence[str] | str] = None, lower: bool = False):
        self.idx_to_label: TDict[int, str] = {}
        self.label_to_idx: TDict[str, int] = {}
        self.frequencies: TDict[int, int] = {}
        self.lower = lower
        self.special: List[int] = []
        if data is not None:
            if isinstance(data, str):
                self.load_file(data)
            else:
                self.add_specials(data)

    # -- size / io -------------------------------------------------------
    def size(self) -> int:
        return len(self.idx_to_label)

    def __len__(self) -> int:
        return self.size()

    def load_file(self, filename: str) -> None:
        with open(filename, "r", encoding="utf-8") as f:
            for line in f:
                fields = line.split()
                if len(fields) < 2:
                    continue
                self.add(fields[0], int(fields[1]))

    def write_file(self, filename: str) -> None:
        with open(filename, "w", encoding="utf-8") as f:
            for i in range(self.size()):
                f.write("%s %d\n" % (self.idx_to_label[i], i))

    def state_dict(self) -> dict:
        return {
            "idx_to_label": {str(k): v for k, v in self.idx_to_label.items()},
            "frequencies": {str(k): v for k, v in self.frequencies.items()},
            "special": list(self.special),
            "lower": self.lower,
        }

    @classmethod
    def from_state_dict(cls, state: dict) -> "Dict":
        d = cls(lower=state.get("lower", False))
        for k, v in state["idx_to_label"].items():
            d.idx_to_label[int(k)] = v
            d.label_to_idx[v] = int(k)
        d.frequencies = {int(k): v for k, v in state.get("frequencies", {}).items()}
        d.special = list(state.get("special", []))
        return d

    # -- lookup ----------------------------------------------------------
    def lookup(self, key: str, default=None):
        key = key.lower() if self.lower else key
        return self.label_to_idx.get(key, default)

    def get_label(self, idx: int, default=None):
        return self.idx_to_label.get(idx, default)

    # -- building --------------------------------------------------------
    def add_special(self, label: str, idx: Optional[int] = None) -> None:
        idx = self.add(label, idx)
        self.special.append(idx)

    def add_specials(self, labels: Iterable[str]) -> None:
        for label in labels:
            self.add_special(label)

    def add(self, label: str, idx: Optional[int] = None) -> int:
        label = label.lower() if self.lower else label
        if idx is not None:
            self.idx_to_label[idx] = label
            self.label_to_idx[label] = idx
        else:
            if label in self.label_to_idx:
                idx = self.label_to_idx[label]
            else:
                idx = len(self.idx_to_label)
                self.idx_to_label[idx] = label
                self.label_to_idx[label] = idx
        self.frequencies[idx] = self.frequencies.get(idx, 0) + 1
        return idx

    def prune(self, size: int) -> "Dict":
        """New Dict keeping the `size` most frequent entries (+ specials).

        Parity note (onmt/Dict.py:93-112): ties broken by descending
        frequency with stable order of first insertion.
        """
        if size >= self.size():
            return self
        freq = np.asarray([self.frequencies[i] for i in range(len(self.frequencies))])
        # stable sort descending = reference torch.sort(descending) semantics
        order = np.argsort(-freq, kind="stable")
        new = Dict(lower=self.lower)
        for i in self.special:
            new.add_special(self.idx_to_label[i])
        for i in order[:size]:
            new.add(self.idx_to_label[int(i)])
        return new

    # -- alignment (pivot losses / copy attention) ------------------------
    def align(self, other: "Dict") -> np.ndarray:
        """id map self->other; missing labels map to PAD (onmt/Dict.py:49-55)."""
        alignment = np.full((self.size(),), C.PAD, dtype=np.int32)
        for idx, label in self.idx_to_label.items():
            j = other.label_to_idx.get(label)
            if j is not None:
                alignment[idx] = j
        return alignment

    # -- conversion -------------------------------------------------------
    def convert_to_idx(
        self,
        labels: Sequence[str],
        unk_word: str = C.UNK_WORD,
        bos_word: Optional[str] = None,
        eos_word: Optional[str] = None,
    ) -> np.ndarray:
        vec: List[int] = []
        if bos_word is not None:
            vec.append(self.lookup(bos_word))
        unk = self.lookup(unk_word)
        vec += [self.lookup(label, default=unk) for label in labels]
        if eos_word is not None:
            vec.append(self.lookup(eos_word))
        return np.asarray(vec, dtype=np.int32)

    def convert_to_labels(self, idx: Sequence[int], stop: int) -> List[str]:
        labels: List[str] = []
        for i in idx:
            labels.append(self.get_label(int(i)))
            if int(i) == stop:
                break
        return labels


def make_nmt_dict(lower: bool = False) -> Dict:
    """Fresh Dict with the 4 onmt specials pre-registered."""
    return Dict([C.PAD_WORD, C.UNK_WORD, C.BOS_WORD, C.EOS_WORD], lower=lower)


def extract_features(tokens: Sequence[str]):
    """Split `word￨feat1￨feat2...` tokens into words + feature columns.

    Parity: onmt fork `onmt/IO.py:67-91 extractFeatures` — empty words are
    skipped entirely (their features too), every kept word must carry the
    same number of features, and the feature count is locked by the first
    word. Returns (words, features, num_features) where features is a list
    of per-column lists aligned with words."""
    words: List[str] = []
    features: List[List[str]] = []
    num_features = None
    for tok in tokens:
        field = tok.split("￨")  # ￨ U+FFE8, the onmt feature separator
        word = field[0]
        if len(word) > 0:
            words.append(word)
            if num_features is None:
                num_features = len(field) - 1
            else:
                assert len(field) - 1 == num_features, \
                    "all words must have the same number of features"
            for i in range(1, len(field)):
                if len(features) <= i - 1:
                    features.append([])
                features[i - 1].append(field[i])
                assert len(features[i - 1]) == len(words)
    return words, features, num_features if num_features else 0


class CaptionVocab:
    """Caption-side vocabulary: ids 1..V; 0 = pad/eos; UNK at the last slot.

    Parity: reference `scripts/prepro_labels.py:46-110` vocab construction and
    `misc/utils.py:49-66` `decode_sequence`.
    """

    def __init__(self, ix_to_word: TDict[str, str]):
        # keys are string ids (reference json convention)
        self.ix_to_word = dict(ix_to_word)
        self.word_to_ix = {w: int(i) for i, w in self.ix_to_word.items()}

    @property
    def vocab_size(self) -> int:
        return len(self.ix_to_word)

    @classmethod
    def build(
        cls,
        token_seqs: Iterable[Sequence[str]],
        count_threshold: int = 5,
        unk_word: str = C.ZH_UNK_WORD,
    ) -> "CaptionVocab":
        """Word-count-threshold vocab (parity: prepro_labels.py:46-78).

        Words with count <= threshold are replaced by `unk_word`, which is
        appended as the final vocab entry iff any word was rare.
        """
        counts: TDict[str, int] = {}
        for seq in token_seqs:
            for w in seq:
                counts[w] = counts.get(w, 0) + 1
        # reference sorts by count desc for vocab order
        ordered = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))
        vocab = [w for w, n in ordered if n > count_threshold]
        bad = [w for w, n in ordered if n <= count_threshold]
        if bad:
            vocab.append(unk_word)
        ix_to_word = {str(i + 1): w for i, w in enumerate(vocab)}
        return cls(ix_to_word)

    def encode(self, tokens: Sequence[str], max_length: int) -> np.ndarray:
        """tokens -> int32[max_length], 0-padded; OOV -> UNK (last slot)."""
        unk = self.vocab_size
        out = np.zeros((max_length,), dtype=np.int32)
        for i, w in enumerate(tokens[:max_length]):
            out[i] = self.word_to_ix.get(w, unk)
        return out

    def decode_sequence(self, seq: np.ndarray, join_with: str = " ") -> List[str]:
        """ids[N, D] -> list of N strings, stopping at the first 0.

        Parity: misc/utils.py:49-66.
        """
        seq = np.asarray(seq)
        if seq.ndim == 1:
            seq = seq[None, :]
        out = []
        for row in seq:
            words = []
            for ix in row:
                ix = int(ix)
                if ix == 0:
                    break
                words.append(self.ix_to_word.get(str(ix), ""))
            out.append(join_with.join(words))
        return out

    def state_dict(self) -> dict:
        return {"ix_to_word": self.ix_to_word}

    @classmethod
    def from_state_dict(cls, state: dict) -> "CaptionVocab":
        return cls(state["ix_to_word"])

    @classmethod
    def from_talk_json(cls, path: str) -> "CaptionVocab":
        """Load from a `*_talk.json` artifact (reference dataloader.py:60-66)."""
        with open(path, "r", encoding="utf-8") as f:
            info = json.load(f)
        return cls(info["ix_to_word"])

    @classmethod
    def from_wtoi_pickle(cls, path: str) -> "CaptionVocab":
        """Migrate the reference's `wtoi_zh.txt` artifact — a Python-2
        text-protocol pickle of {word: index} (50k zh entries). Protocol-0
        text pickles load cleanly under py3."""
        import pickle

        with open(path, "rb") as f:
            wtoi = pickle.load(f)
        return cls({str(int(ix)): w for w, ix in wtoi.items()})
