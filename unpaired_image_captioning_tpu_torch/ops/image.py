"""Image front end, plain PyTorch (counterpart of
`unpaired_image_captioning_tpu/ops/image.py`).

uint8 [B, H, W, C] -> bilinear resize (half-pixel centres) -> ImageNet
normalisation, f32 [B, h_out, w_out, C]. The resize is separable: per
channel `R_h @ plane @ R_w^T` with the matrices of `_interp_matrix`, then
`(x / 255 - mean) / std`; for C != 3 every channel takes the mean of the
three statistics. `resize_normalize_plain` is the JAX package's dense
einsum route (`image.py:76-80`) written out; the CUDA kernel
(`kernels/image.py`, `csrc/image_front_end.cu`) computes the same function
from each matrix row's two taps (`taps`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# torchvision normalisation (the JAX package's models/resnet.py)
IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


@functools.lru_cache(maxsize=32)
def _interp_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] bilinear interpolation weights (half-pixel centers,
    matching jax.image.resize(method='linear')). Cached: callers must not
    write to it."""
    m = np.zeros((n_out, n_in), np.float32)
    scale = n_in / n_out
    for o in range(n_out):
        src = (o + 0.5) * scale - 0.5
        lo = int(np.floor(src))
        frac = src - lo
        lo_c = min(max(lo, 0), n_in - 1)
        hi_c = min(max(lo + 1, 0), n_in - 1)
        m[o, lo_c] += 1.0 - frac
        m[o, hi_c] += frac
    m.flags.writeable = False
    return m


@functools.lru_cache(maxsize=32)
def taps(n_in: int, n_out: int):
    """Each output index's two taps, read off `_interp_matrix(n_in, n_out)`:
    (idx int32 [n_out, 2], weight f32 [n_out, 2]). A row has one or two
    non-zero entries; a row with one (its two taps clamped onto one index,
    or a zero fraction) gives (i, m[o, i]) and (i, 0)."""
    m = _interp_matrix(n_in, n_out)
    idx = np.zeros((n_out, 2), np.int32)
    wt = np.zeros((n_out, 2), np.float32)
    for o, row in enumerate(m):
        nz = np.flatnonzero(row)
        idx[o] = (nz[0], nz[-1])
        wt[o, 0] = row[nz[0]]
        wt[o, 1] = row[nz[-1]] if len(nz) > 1 else 0.0
    idx.flags.writeable = False
    wt.flags.writeable = False
    return idx, wt


def norm_stats(c: int):
    """(mean, std) f32 [C]: the ImageNet statistics for C = 3, else their
    means for every channel (`image.py:70-72`)."""
    if c == 3:
        return IMAGENET_MEAN, IMAGENET_STD
    return (np.full((c,), np.float32(IMAGENET_MEAN.mean()), np.float32),
            np.full((c,), np.float32(IMAGENET_STD.mean()), np.float32))


def preprocess_images(imgs: np.ndarray) -> np.ndarray:
    """uint8 [B, H, W, 3] -> normalized float32, on the host (torchvision
    transform parity used by prepro_feats.py / dataloaderraw.py)."""
    x = imgs.astype(np.float32) / 255.0
    return (x - IMAGENET_MEAN) / IMAGENET_STD


def resize_normalize_plain(imgs: torch.Tensor, *, h_out: int = 448,
                           w_out: int = 448) -> torch.Tensor:
    """uint8 [B, H, W, C] -> normalized f32 [B, h_out, w_out, C], by the
    dense einsum route."""
    _, h_in, w_in, c = imgs.shape
    dev = imgs.device
    rh = torch.from_numpy(_interp_matrix(h_in, h_out).copy()).to(dev)
    rw_t = torch.from_numpy(_interp_matrix(w_in, w_out).T.copy()).to(dev)
    mean, std = (torch.from_numpy(s.copy()).to(dev) for s in norm_stats(c))
    x = imgs.to(torch.float32)
    x = torch.einsum("oh,bhwc->bowc", rh, x)
    x = torch.einsum("bowc,wq->boqc", x, rw_t)
    return (x / 255.0 - mean) / std
