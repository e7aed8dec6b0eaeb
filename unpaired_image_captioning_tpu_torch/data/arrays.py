"""Files of named arrays: the caption labels, the NMT corpus and the h5
feature variant, read and written by the file's suffix.

- `.npz` (numpy) holds the same dataset names as the JAX package's HDF5
  files (`labels`, `label_start_ix`, `label_end_ix`, `label_length`;
  `src`, `tgt`, `src_feat_{j}`; `fc`, `att`) and needs nothing beyond
  numpy;
- any other suffix is read and written as HDF5 through `h5py`, imported
  only here. A machine without `h5py` raises an `ImportError` that names
  the `.npz` route: `scripts/h5_to_npz.py` converts a file where `h5py` is
  installed, and a writer given a `.npz` path needs no `h5py`.

`write_arrays` stores each array as given, so the writers keep the JAX
package's dtypes (int32 `labels`, `src`, `tgt` and `*_feat_{j}`; int64
`label_start_ix`, `label_end_ix` and `label_length`).
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _h5py(path: str, writing: bool = False):
    try:
        import h5py
    except ImportError as e:
        fix = ("give the output the suffix .npz, which the port's loaders "
               "read as well" if writing else
               "convert the file where h5py is (python -m "
               "unpaired_image_captioning_tpu_torch.scripts.h5_to_npz "
               f"{path}) and pass the .npz")
        raise ImportError(
            f"{'writing' if writing else 'reading'} {path} needs h5py, which "
            f"is not installed here; {fix}") from e
    return h5py


def read_arrays(path: str) -> Dict[str, np.ndarray]:
    """Every top-level array of the file at `path`, by name."""
    if path.endswith(".npz"):
        with np.load(path) as blob:
            return {k: blob[k] for k in blob.files}
    with _h5py(path).File(path, "r") as f:
        return {k: f[k][...] for k in f.keys()}


def open_array(path: str, name: str):
    """The array `name` of the file at `path`, indexable by row: an HDF5
    dataset read lazily, or the `.npz` array read whole."""
    if path.endswith(".npz"):
        with np.load(path) as blob:
            return blob[name]
    return _h5py(path).File(path, "r")[name]


def write_arrays(path: str, arrays: Dict[str, np.ndarray]) -> None:
    """Write the named `arrays` to `path`: `np.savez` for a `.npz`, HDF5
    datasets otherwise."""
    if path.endswith(".npz"):
        np.savez(path, **arrays)
        return
    with _h5py(path, writing=True).File(path, "w") as f:
        for k, v in arrays.items():
            f[k] = v
