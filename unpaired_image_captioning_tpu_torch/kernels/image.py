"""Image front end: the wrapper of `csrc/image_front_end.cu`.

Replaces the TPU kernel `unpaired_image_captioning_tpu/ops/image.py
::_front_end_kernel` (routed there by `resize_normalize`): uint8 [B, H, W,
C] -> bilinear resize to [h_out, w_out] -> `(x / 255 - mean) / std`, in
`out_dtype` (f32, or bf16 as JAX's `resize_normalize(out_dtype=...)`
casts: the f32 value rounded to nearest even as it is stored, bit for bit
`data.dataloader.to_bfloat16`). The plain version and the tap tables are
in `ops/image.py`.

`resize_normalize` runs the plain version for CPU tensors and launches the
kernel for CUDA tensors; it never routes a CUDA tensor to the plain
version. `launches` counts kernel launches, `bf16_launches` those of them
with a bf16 output.
"""

from __future__ import annotations

import functools

import torch

from ..ops.image import norm_stats, resize_normalize_plain, taps
from . import build

launches = 0
bf16_launches = 0
_OUT_TYPES = (torch.float32, torch.bfloat16)


@functools.lru_cache(maxsize=16)
def _tables(h_in: int, w_in: int, h_out: int, w_out: int, c: int,
            device: torch.device):
    """The kernel's tap tables and statistics on `device` (read-only)."""
    out = []
    for n_in, n_out in ((h_in, h_out), (w_in, w_out)):
        idx, wt = taps(n_in, n_out)
        out += [torch.from_numpy(idx.copy()).to(device),
                torch.from_numpy(wt.copy()).to(device)]
    out += [torch.from_numpy(s.copy()).to(device) for s in norm_stats(c)]
    return tuple(out)


def resize_normalize(imgs: torch.Tensor, *, h_out: int = 448,
                     w_out: int = 448,
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 [B, H, W, C] -> normalized [B, h_out, w_out, C] in out_dtype
    (float32 or bfloat16)."""
    global launches, bf16_launches
    if out_dtype not in _OUT_TYPES:
        raise ValueError(f"resize_normalize: no kernel entry for out_dtype "
                         f"{out_dtype}: float32 or bfloat16")
    if imgs.device.type == "cpu":
        return resize_normalize_plain(imgs, h_out=h_out, w_out=w_out,
                                      out_dtype=out_dtype)
    if imgs.device.type != "cuda":
        raise ValueError(f"resize_normalize: unsupported device {imgs.device}")
    if imgs.dtype != torch.uint8 or imgs.dim() != 4:
        raise ValueError(f"resize_normalize: expected uint8 [B, H, W, C], got "
                         f"{imgs.dtype} {tuple(imgs.shape)}")
    if not imgs.is_contiguous():
        raise ValueError("resize_normalize: imgs must be contiguous")
    b, h_in, w_in, c = imgs.shape
    if min(b, h_in, w_in, c, h_out, w_out) < 1:
        raise ValueError(f"resize_normalize: empty shape {tuple(imgs.shape)} "
                         f"-> [{h_out}, {w_out}]")
    row_idx, row_w, col_idx, col_w, mean, std = _tables(
        h_in, w_in, h_out, w_out, c, imgs.device)
    out = torch.empty((b, h_out, w_out, c), dtype=out_dtype,
                      device=imgs.device)
    obf = int(out_dtype == torch.bfloat16)
    lib = build.load()
    stream = torch.cuda.current_stream(imgs.device).cuda_stream
    err = lib.image_front_end_mixed(
        imgs.data_ptr(), row_idx.data_ptr(), row_w.data_ptr(),
        col_idx.data_ptr(), col_w.data_ptr(), mean.data_ptr(), std.data_ptr(),
        out.data_ptr(), b, h_in, w_in, c, h_out, w_out, obf, stream)
    build.check(err, "image_front_end_mixed")
    launches += 1
    bf16_launches += obf
    return out
