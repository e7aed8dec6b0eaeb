"""NMT dataset: padded parallel corpus batches (counterpart of
`unpaired_image_captioning_tpu/data/nmt_dataset.py`).

Parity: reference `misc/dataloader/onmt_dataset_h5.py:11-115` — pad to max
length, batch by index, expose `(src, lengths, tgt)`; PAD=0, BOS/EOS
pre-applied to tgt. The reference sorts each batch by decreasing source
length for packed RNNs and transposes to time-major; neither is needed
under masking + batch-major layouts, so batches keep corpus order
(volatile only through shuffling).

Storage: a file with arrays `src` [N, S] and `tgt` [N, T] int32
(0-padded) and optional `src_feat_{j}`, as `.npz` or HDF5
(`data/arrays.py`), or in-memory numpy arrays. Dicts ride in `vocab.Dict`
json. Batches are numpy; the trainer uploads them.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from .. import constants as C
from .arrays import read_arrays


class NMTDataset:
    def __init__(self, src: np.ndarray, tgt: np.ndarray, batch_size: int,
                 *, shuffle: bool = False, seed: int = 0, src_feats=None,
                 curriculum: int = 0, batch_shuffle: bool = False):
        """curriculum (fork train.py:245-258 `-curriculum`): keep the
        corpus's length-sorted order for the first N epochs before any
        shuffling. batch_shuffle (`-extra_shuffle`): permute batch-sized
        BLOCKS each epoch instead of samples — preserves the
        length-homogeneous batches the bucketed corpus order gives, like
        the fork's batchOrder=randperm(numBatches)."""
        if src.shape[0] != tgt.shape[0]:
            raise ValueError(f"src has {src.shape[0]} rows, tgt "
                             f"{tgt.shape[0]}")
        self.src = np.asarray(src, np.int32)
        self.tgt = np.asarray(tgt, np.int32)
        # `word￨feat` source-feature streams (src_feat_{j} arrays): stacked
        # to [N, S, n_feat], batched alongside src
        self.src_feats = (None if src_feats is None or not len(src_feats)
                          else np.stack([np.asarray(a, np.int32)
                                         for a in src_feats], axis=-1))
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.curriculum = curriculum
        self.batch_shuffle = batch_shuffle
        self.rng = np.random.RandomState(seed)
        self.epoch = 0
        self.order = np.arange(len(self.src))
        self._maybe_shuffle()
        self.batch_idx = 0

    def _maybe_shuffle(self) -> None:
        if self.epoch < self.curriculum:
            self.order = np.arange(len(self.src))
            return
        if self.batch_shuffle:
            n = len(self.src)
            base = np.arange(n)
            nb = (n + self.batch_size - 1) // self.batch_size
            perm = self.rng.permutation(nb)
            self.order = np.concatenate(
                [base[b * self.batch_size:(b + 1) * self.batch_size]
                 for b in perm])
        elif self.shuffle:
            # in place on the current order: the permutation stream of the
            # JAX package's dataset, which its resume tests pin
            self.rng.shuffle(self.order)

    @classmethod
    def from_h5(cls, path: str, batch_size: int, **kw) -> "NMTDataset":
        """The corpus file at `path`: `.npz`, or HDF5 through h5py."""
        arrays = read_arrays(path)
        feats = []
        while f"src_feat_{len(feats)}" in arrays:
            feats.append(arrays[f"src_feat_{len(feats)}"])
        return cls(arrays["src"], arrays["tgt"], batch_size,
                   src_feats=feats or None, **kw)

    def __len__(self) -> int:
        return (len(self.src) + self.batch_size - 1) // self.batch_size

    @property
    def num_batches(self) -> int:
        return len(self)

    def state_dict(self) -> dict:
        # rng state included: without it a resumed run's NEXT epoch-wrap
        # shuffle diverges from the uninterrupted run's
        r = self.rng.get_state()
        return {"batch_idx": self.batch_idx, "order": self.order.tolist(),
                "epoch": self.epoch,
                "rng": [r[0], np.asarray(r[1]).tolist(), r[2], r[3], r[4]]}

    def load_state_dict(self, state: dict) -> None:
        self.batch_idx = state["batch_idx"]
        self.order = np.asarray(state["order"], np.int64)
        self.epoch = state.get("epoch", 0)
        if "rng" in state:
            r = state["rng"]
            self.rng.set_state((r[0], np.asarray(r[1], np.uint32), int(r[2]),
                                int(r[3]), float(r[4])))

    def next_batch(self) -> Tuple[Dict[str, np.ndarray], bool]:
        """Returns (batch dict, wrapped flag). Batch is fixed-shape
        [batch_size, ...]: the tail batch wraps around (the reference
        instead emits a short tail batch)."""
        n = len(self.src)
        start = self.batch_idx * self.batch_size
        idx = self.order[np.arange(start, start + self.batch_size) % n]
        wrapped = start + self.batch_size >= n
        self.batch_idx += 1
        if wrapped:
            self.batch_idx = 0
            self.epoch += 1
            self._maybe_shuffle()
        src = self.src[idx]
        tgt = self.tgt[idx]
        lengths = (src != C.PAD).sum(axis=1).astype(np.int32)
        batch = {"src": src, "tgt": tgt, "lengths": lengths}
        if self.src_feats is not None:
            batch["src_feats"] = self.src_feats[idx]
        return batch, wrapped
