"""The repository's C++ helper on the host (counterpart of the
`ptb_tokenize` and `query_integral_image` parts of
`unpaired_image_captioning_tpu/native.py`).

The helper's source is `native/uic_native.cpp` at the repository's root.
The first call builds it with the host's C++ compiler into the port's
git-ignored `_build/` (named by a hash of the source, written to a
temporary name and renamed into place) and loads it with ctypes. Where no
compiler is present, the pure-Python twins below are the route: they run
on the host as the helper does and give the same results (the caption
metrics read the same tokens from either on the captions they score; the
word cloud's free-position search returns the same position). A build
that fails raises with the compiler's errors.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

PKG_DIR = Path(__file__).resolve().parent
SOURCE = PKG_DIR.parent / "native" / "uic_native.cpp"
BUILD_DIR = PKG_DIR / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")


@functools.lru_cache(maxsize=None)
def _lib() -> Optional[ctypes.CDLL]:
    if not SOURCE.exists():
        return None
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"libuic_native-{digest}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.tmp.{os.getpid()}")
        try:
            done = subprocess.run([os.environ.get("CXX", "g++"), *CXX_FLAGS,
                                   "-o", str(tmp), str(SOURCE)],
                                  capture_output=True, text=True, timeout=120)
        except OSError:            # no compiler
            return None
        if done.returncode:
            raise RuntimeError(f"building {SOURCE.name} failed "
                               f"({done.returncode}):\n{done.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.ptb_tokenize.restype = ctypes.c_int
    lib.ptb_tokenize.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                 ctypes.c_int]
    lib.query_integral_image.restype = ctypes.c_int
    lib.query_integral_image.argtypes = [
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    return lib


def has_native() -> bool:
    return _lib() is not None


_COCO_PUNCT = {"''", "'", "``", "`", "-LRB-", "-RRB-", "-LCB-", "-RCB-",
               ".", "?", "!", ",", ":", "-", "--", "...", ";"}


def _ptb_tokenize_py(text: str) -> str:
    # contractions, then split punctuation, drop coco punctuation list
    t = re.sub(r"n't\b", " n't", text)
    t = re.sub(r"'(s|re|ve|ll|d|m)\b", r" '\1", t)
    toks = re.findall(r"[A-Za-z0-9\u0080-\uffff]+"
                      r"(?:[-.][A-Za-z0-9\u0080-\uffff]+)*"
                      r"|'[a-z]+|n't|[^\sA-Za-z0-9]+", t)
    return " ".join(tok.lower() for tok in toks if tok not in _COCO_PUNCT)


def ptb_tokenize(text: str) -> str:
    """coco-caption PTBTokenizer's role: lowercase, split contractions and
    punctuation, drop the coco punctuation list."""
    lib = _lib()
    if lib is None:
        return _ptb_tokenize_py(text)
    raw = text.encode("utf-8")
    cap = max(256, len(raw) * 2 + 16)
    buf = ctypes.create_string_buffer(cap)
    n = lib.ptb_tokenize(raw, buf, cap)
    if n < 0:
        return _ptb_tokenize_py(text)
    return buf.value.decode("utf-8")


def _query_integral_image_py(integral: np.ndarray, size_x: int, size_y: int,
                             random_hit: int) -> Optional[Tuple[int, int]]:
    h, w = integral.shape
    hits = []
    for x in range(h - size_x):
        for y in range(w - size_y):
            area = (int(integral[x + size_x, y + size_y])
                    + int(integral[x, y]) - int(integral[x + size_x, y])
                    - int(integral[x, y + size_y]))
            if area == 0:
                hits.append((x, y))
    if not hits:
        return None
    return hits[random_hit % len(hits)]


def query_integral_image(integral: np.ndarray, size_x: int, size_y: int,
                         random_hit: int) -> Optional[Tuple[int, int]]:
    """Word-cloud free-position search (Cython kernel parity): the
    `random_hit`-th (modulo their count) top-left corner (row, col) where a
    size_x x size_y box covers only zeros of the occupancy whose summed
    area table is `integral` [h, w]; None where the box fits nowhere."""
    integral = np.ascontiguousarray(integral, np.uint32)
    lib = _lib()
    if lib is None:
        return _query_integral_image_py(integral, size_x, size_y, random_hit)
    h, w = integral.shape
    ox = ctypes.c_int(0)
    oy = ctypes.c_int(0)
    found = lib.query_integral_image(
        integral.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), h, w,
        size_x, size_y, random_hit, ctypes.byref(ox), ctypes.byref(oy))
    if not found:
        return None
    return int(ox.value), int(oy.value)
