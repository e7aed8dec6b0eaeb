"""Synthetic artifacts in the reference's on-disk formats, for tests and
`chip_smoke.py` (counterpart of
`unpaired_image_captioning_tpu/data/synthetic.py`; the same seed gives the
same arrays).

The label file is written as `.npz` (`data/arrays.py`), which needs no
`h5py`; `scripts/h5_to_npz.py` and the loaders' HDF5 route make the two
interchangeable.
"""

from __future__ import annotations

import json
import os
from typing import Tuple

import numpy as np

from .. import constants as C


def make_caption_artifacts(tmpdir: str, *, n_images: int = 12,
                           vocab_size: int = 40, seq_length: int = 10,
                           caps_per_img: int = 3, fc_dim: int = 32,
                           att_dim: int = 24, att_len: int = 6,
                           cls_dim: int = 16, seed: int = 0, n_val: int = 2,
                           n_test: int = 2) -> Tuple[str, str, dict]:
    """Writes talk.json + label.npz; returns (json_path, label_path,
    in_memory feature dict usable as CaptionDataLoader(in_memory=...)).
    The last n_val + n_test images are the val and test splits."""
    rng = np.random.RandomState(seed)
    ix_to_word = {str(i + 1): f"w{i}" for i in range(vocab_size)}
    images = []
    splits = (["train"] * (n_images - n_val - n_test) + ["val"] * n_val
              + ["test"] * n_test)
    for i in range(n_images):
        images.append({"id": i, "split": splits[i],
                       "file_path": f"img{i}.jpg", "width": 64,
                       "height": 48})
    labels = []
    start, end = [], []
    pos = 1
    for i in range(n_images):
        start.append(pos)
        for _ in range(caps_per_img):
            ln = rng.randint(3, seq_length + 1)
            row = np.zeros((seq_length,), np.int32)
            row[:ln] = rng.randint(1, vocab_size + 1, size=ln)
            labels.append(row)
            pos += 1
        end.append(pos - 1)
    json_path = os.path.join(tmpdir, "talk.json")
    with open(json_path, "w") as f:
        json.dump({"ix_to_word": ix_to_word, "images": images}, f)
    label_path = os.path.join(tmpdir, "label.npz")
    labels = np.stack(labels)
    np.savez(label_path, labels=labels,
             label_start_ix=np.asarray(start, np.int64),
             label_end_ix=np.asarray(end, np.int64),
             label_length=(labels > 0).sum(1).astype(np.int64))
    mem = {
        "fc": {str(i): rng.randn(fc_dim).astype(np.float32)
               for i in range(n_images)},
        "att": {str(i): rng.randn(att_len, att_dim).astype(np.float32)
                for i in range(n_images)},
        "cls": {str(i): rng.rand(att_len, cls_dim).astype(np.float32)
                for i in range(n_images)},
        "box": {str(i): np.abs(rng.rand(att_len, 4)).astype(np.float32)
                for i in range(n_images)},
    }
    return json_path, label_path, mem


def write_feature_dirs(tmpdir: str, mem: dict) -> Tuple[str, str]:
    """Writes the `fc` and `att` features of `mem` as one `.npy` per image
    under tmpdir/fc and tmpdir/att (the loader's `input_fc_dir` /
    `input_att_dir`); returns the two directories."""
    dirs = []
    for kind in ("fc", "att"):
        d = os.path.join(tmpdir, kind)
        os.makedirs(d, exist_ok=True)
        for i, v in mem[kind].items():
            np.save(os.path.join(d, f"{i}.npy"), v)
        dirs.append(d)
    return dirs[0], dirs[1]


def make_nmt_corpus(*, n_pairs: int = 64, src_vocab: int = 30,
                    tgt_vocab: int = 28, src_len: int = 8, tgt_len: int = 9,
                    seed: int = 0):
    """Returns (src [N,S], tgt [N,T]) int32 with onmt id conventions:
    src plain 0-padded; tgt = BOS ... EOS 0-padded."""
    rng = np.random.RandomState(seed)
    src = np.zeros((n_pairs, src_len), np.int32)
    tgt = np.zeros((n_pairs, tgt_len), np.int32)
    for i in range(n_pairs):
        sl = rng.randint(3, src_len + 1)
        tl = rng.randint(3, tgt_len - 1)
        src[i, :sl] = rng.randint(4, src_vocab, size=sl)
        tgt[i, 0] = C.BOS
        tgt[i, 1: 1 + tl] = rng.randint(4, tgt_vocab, size=tl)
        tgt[i, 1 + tl] = C.EOS
    return src, tgt
