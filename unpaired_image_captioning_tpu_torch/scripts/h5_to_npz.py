"""Convert an HDF5 file of named arrays (a caption label file, an NMT
corpus, an h5 feature file) to the `.npz` the port's loaders also read
(`data/arrays.py`), for machines without `h5py`:

    python -m unpaired_image_captioning_tpu_torch.scripts.h5_to_npz \\
        data/chinese_talk_label.h5 [--output data/chinese_talk_label.npz]

Run it where `h5py` is installed. Every top-level dataset keeps its name,
dtype and shape.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..data.arrays import read_arrays


def main(argv=None) -> str:
    p = argparse.ArgumentParser("h5_to_npz")
    p.add_argument("input", help="the .h5 file")
    p.add_argument("--output", default="",
                   help="the .npz to write (default: the input's name with "
                   "the suffix .npz)")
    a = p.parse_args(argv)
    if a.input.endswith(".npz"):
        raise SystemExit(f"{a.input} is already an .npz")
    out = a.output or os.path.splitext(a.input)[0] + ".npz"
    arrays = read_arrays(a.input)
    np.savez(out, **arrays)
    print(f"wrote {out}: " + ", ".join(
        f"{k} {v.dtype}{list(v.shape)}" for k, v in arrays.items()))
    return out


if __name__ == "__main__":
    main()
