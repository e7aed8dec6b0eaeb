"""Reference n-gram document frequencies for SCST CIDEr-D (counterpart of
`unpaired_image_captioning_tpu/scripts/prepro_ngrams.py`).

Reference `scripts/prepro_ngrams.py:32-60`: for every training image,
collect the distinct n-grams (n = 1..4) over its reference captions and
count the images that contain each; save them with the image count. The
artifact is an `.npz` (keys are token-id tuples; the reference's string
keys are equivalent, id <-> token being a bijection), the same file the
JAX package writes and reads:

    python -m unpaired_image_captioning_tpu_torch.scripts.prepro_ngrams \\
        --input_label_h5 data/chinese_talk_label.npz \\
        --input_json data/chinese_talk.json --output data/aic-train-idxs.npz

`load_df_table(cfg.cached_tokens, device)` turns it into the df table on
the device that `Trainer(df_table=...)` scores SCST rewards with.
"""

from __future__ import annotations

import argparse
import os
from collections import defaultdict

import numpy as np


def compute_df(labels: np.ndarray, label_start_ix: np.ndarray,
               label_end_ix: np.ndarray, split_mask=None, n_max: int = 4):
    """labels: [M, L] int caption tensors (0-padded); label_start_ix /
    label_end_ix: each image's caption rows, 1-based and inclusive.
    Returns ({n-gram tuple: the number of images that hold it}, images)."""
    df = defaultdict(float)
    n_imgs = 0
    for i in range(len(label_start_ix)):
        if split_mask is not None and not split_mask[i]:
            continue
        n_imgs += 1
        seen = set()
        for row in labels[label_start_ix[i] - 1: label_end_ix[i]]:
            toks = [int(t) for t in row if t > 0]
            for n in range(1, n_max + 1):
                for j in range(len(toks) - n + 1):
                    seen.add(tuple(toks[j: j + n]))
        for ng in seen:
            df[ng] += 1
    return dict(df), n_imgs


def save_df(path: str, df: dict, ref_len: float) -> None:
    ngrams = np.empty(len(df), dtype=object)
    dfs = np.empty(len(df), dtype=np.float32)
    for i, (ng, v) in enumerate(df.items()):
        ngrams[i] = np.asarray(ng, np.int32)
        dfs[i] = v
    np.savez(path, ngrams=ngrams, dfs=dfs, ref_len=np.float64(ref_len),
             allow_pickle=True)


def load_df(path: str):
    blob = np.load(path, allow_pickle=True)
    df = {tuple(int(t) for t in ng): float(v)
          for ng, v in zip(blob["ngrams"], blob["dfs"])}
    return df, float(blob["ref_len"])


def load_df_table(path: str, device="cuda"):
    """The df table of the prepro_ngrams cache at `path` (or `path` +
    ".npz") on `device`; the empty table when there is no such `.npz`
    (reference --cached_tokens, rewards.py init_scorer)."""
    from ..ops.cider import build_df_table, empty_df_table

    for cand in (path, path + ".npz"):
        if cand and os.path.exists(cand) and cand.endswith(".npz"):
            df, ref_len = load_df(cand)
            return build_df_table(df, ref_len, device)
    return empty_df_table(device)


def main(argv=None):
    import json

    from ..data.arrays import read_arrays

    p = argparse.ArgumentParser("prepro_ngrams")
    p.add_argument("--input_label_h5", required=True,
                   help="the label file, .npz or HDF5")
    p.add_argument("--input_json", required=True)
    p.add_argument("--output", required=True, help="output .npz path")
    p.add_argument("--split", default="train")
    a = p.parse_args(argv)

    with open(a.input_json, encoding="utf-8") as f:
        info = json.load(f)
    arrays = read_arrays(a.input_label_h5)
    labels = arrays["labels"]
    start, end = arrays["label_start_ix"], arrays["label_end_ix"]
    mask = [img.get("split", "train") == a.split for img in info["images"]]
    df, n_imgs = compute_df(labels, start, end, split_mask=mask)
    save_df(a.output, df, float(n_imgs))
    print(f"wrote {a.output}: {len(df)} n-grams over {n_imgs} images")


if __name__ == "__main__":
    main()
