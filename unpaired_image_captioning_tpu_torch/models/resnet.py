"""ResNet image encoder (50/101/152) as an `nn.Module` (counterpart of
`unpaired_image_captioning_tpu/models/resnet.py`).

`my_resnet(img [B, H, W, 3]) -> (fc [B, 2048], att [B, s, s, 2048])` keeps
the JAX package's NHWC layout at its edges; inside, the convolutions run in
PyTorch's NCHW through `torch.nn.functional.conv2d` (the JAX package leaves
them to XLA). BatchNorm runs in inference mode with the stored statistics,
eps 1e-5. `forward` is the JAX `ResNet.apply`: the [B, H/32, W/32, 2048]
feature map.

Padding is XLA's `SAME`, not torchvision's symmetric padding: for an even
input the extra row and column go AFTER, so the 7x7/2 stem at 448 pads
(2, 3) and the 3x3/2 max pool and bottleneck conv pad (0, 1), the pool
with -inf. The att grid is `jax.image.resize(method="linear")`: the
identity where the map is already att_size (448 -> 14), a triangle kernel
widened by 1/scale (antialiased) when it shrinks.

The state dict's keys are the JAX parameter tree's paths (`conv1`,
`bn1.scale`, `layers.2.0.downsample.bn.var`, ...) with the conv weights in
PyTorch's OIHW layout; `bridge.resnet_state_from_jax` converts a JAX tree
(HWIO), `convert_torchvision_state_dict` a torchvision checkpoint.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.image import IMAGENET_MEAN, IMAGENET_STD, preprocess_images
from .base import resolve_device

BLOCKS = {"resnet_tiny": (1, 1, 1, 1),  # CI-sized variant for CLI tests
          "resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3),
          "resnet152": (3, 8, 36, 3)}

BN_EPS = 1e-5


def _same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """XLA SAME padding (before, after) of one spatial axis."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """SAME convolution of NCHW x with OIHW w."""
    ph = _same_pads(x.shape[2], w.shape[2], stride)
    pw = _same_pads(x.shape[3], w.shape[3], stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return F.conv2d(x, w, stride=stride, padding=(ph[0], pw[0]))
    return F.conv2d(F.pad(x, (pw[0], pw[1], ph[0], ph[1])), w, stride=stride)


def max_pool_same(x: torch.Tensor) -> torch.Tensor:
    """3x3/2 max pool with SAME padding by -inf (`reduce_window`)."""
    ph = _same_pads(x.shape[2], 3, 2)
    pw = _same_pads(x.shape[3], 3, 2)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
    return F.max_pool2d(x, 3, 2)


@functools.lru_cache(maxsize=32)
def linear_resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out] f32 weights of `jax.image.resize(method="linear")`
    along one axis (jax `compute_weight_mat` with the triangle kernel,
    antialiased, no translation)."""
    f32 = np.float32
    inv = f32(1.0 / (n_out / n_in))
    kernel_scale = max(inv, f32(1.0))
    sample_f = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv - f32(0.5)
    x = (np.abs(sample_f[None, :] - np.arange(n_in, dtype=f32)[:, None])
         / kernel_scale)
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    out = np.where(inside[None, :], w, f32(0.0)).astype(f32)
    out.flags.writeable = False
    return out


def resize_linear_nchw(x: torch.Tensor, h_out: int, w_out: int):
    """`jax.image.resize(..., method="linear")` over the spatial axes of an
    NCHW tensor; an axis whose size does not change is left as it is, as
    jax does."""
    if x.shape[2] != h_out:
        wh = torch.from_numpy(linear_resize_weights(x.shape[2], h_out).copy())
        x = torch.einsum("bchw,ho->bcow", x, wh.to(x.device, x.dtype))
    if x.shape[3] != w_out:
        ww = torch.from_numpy(linear_resize_weights(x.shape[3], w_out).copy())
        x = torch.einsum("bchw,wo->bcho", x, ww.to(x.device, x.dtype))
    return x


class BatchNorm(nn.Module):
    """Inference BatchNorm over the channels of NCHW: (x - mean) *
    (rsqrt(var + eps) * scale) + offset, in the JAX package's order."""

    def __init__(self, c: int, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones((c,), device=device))
        self.offset = nn.Parameter(torch.zeros((c,), device=device))
        self.register_buffer("mean", torch.zeros((c,), device=device))
        self.register_buffer("var", torch.ones((c,), device=device))

    def forward(self, x):
        inv = torch.rsqrt(self.var + BN_EPS) * self.scale
        return ((x - self.mean[:, None, None]) * inv[:, None, None]
                + self.offset[:, None, None])


class Downsample(nn.Module):
    def __init__(self, cin: int, cout: int, device=None):
        super().__init__()
        self.conv = nn.Parameter(torch.empty((cout, cin, 1, 1), device=device))
        self.bn = BatchNorm(cout, device)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int, downsample: bool,
                 device=None):
        super().__init__()
        cout = planes * 4
        self.stride = stride
        self.conv1 = nn.Parameter(torch.empty((planes, cin, 1, 1),
                                              device=device))
        self.bn1 = BatchNorm(planes, device)
        self.conv2 = nn.Parameter(torch.empty((planes, planes, 3, 3),
                                              device=device))
        self.bn2 = BatchNorm(planes, device)
        self.conv3 = nn.Parameter(torch.empty((cout, planes, 1, 1),
                                              device=device))
        self.bn3 = BatchNorm(cout, device)
        self.downsample = Downsample(cin, cout, device) if downsample else None

    def forward(self, x):
        out = F.relu(self.bn1(conv(x, self.conv1)))
        out = F.relu(self.bn2(conv(out, self.conv2, self.stride)))
        out = self.bn3(conv(out, self.conv3))
        identity = x
        if self.downsample is not None:
            identity = self.downsample.bn(
                conv(x, self.downsample.conv, self.stride))
        return F.relu(out + identity)


class ResNet(nn.Module):
    """The bottleneck ResNet of `depth` ("resnet50", "resnet101",
    "resnet152" or "resnet_tiny"), on the card unless `device` names
    another."""

    def __init__(self, depth: str = "resnet101", *, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.depth = depth
        self.conv1 = nn.Parameter(torch.empty((64, 3, 7, 7), device=dev))
        self.bn1 = BatchNorm(64, dev)
        self.layers = nn.ModuleList()
        cin = 64
        for li, n_blocks in enumerate(BLOCKS[depth]):
            planes = 64 * (2 ** li)
            layer = nn.ModuleList()
            for b in range(n_blocks):
                stride = 2 if (b == 0 and li > 0) else 1
                layer.append(Bottleneck(cin, planes, stride, b == 0, dev))
                cin = planes * 4
            self.layers.append(layer)

    @property
    def device(self) -> torch.device:
        return self.conv1.device

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "ResNet":
        """He-normal convolutions (std sqrt(2 / fan_in)) and identity
        BatchNorm, as the JAX `init_params` draws them (other numbers: a
        torch generator)."""
        for name, p in self.named_parameters():
            if p.dim() == 4:
                fan_in = p.shape[1] * p.shape[2] * p.shape[3]
                p.copy_(torch.randn(p.shape, generator=generator,
                                    device=generator.device)
                        * np.sqrt(2.0 / fan_in))
            elif name.endswith("scale"):
                p.fill_(1.0)
            else:
                p.zero_()
        for name, buf in self.named_buffers():
            buf.fill_(1.0 if name.endswith("var") else 0.0)
        return self

    def _features_nchw(self, img: torch.Tensor) -> torch.Tensor:
        x = img.permute(0, 3, 1, 2).contiguous()
        x = conv(x, self.conv1, 2)
        x = F.relu(self.bn1(x))
        x = max_pool_same(x)
        for layer in self.layers:
            for blk in layer:
                x = blk(x)
        return x

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        """img: [B, H, W, 3] normalized images -> [B, H/32, W/32, 2048]."""
        return self._features_nchw(img).permute(0, 2, 3, 1)

    def my_resnet(self, img: torch.Tensor, att_size: int = 14):
        """myResnet parity (resnet_utils.py:11-27): img [B, H, W, 3] ->
        (fc [B, 2048], att [B, att_size, att_size, 2048])."""
        feat = self._features_nchw(img)
        fc = feat.mean(dim=(2, 3))
        att = resize_linear_nchw(feat, att_size, att_size)
        return fc, att.permute(0, 2, 3, 1)


def convert_torchvision_state_dict(state: Dict[str, "np.ndarray"],
                                   depth: str = "resnet101") -> dict:
    """torchvision resnet state_dict (numpy- or tensor-valued) -> the port's
    ResNet state dict (conv weights stay OIHW)."""
    def t(name):
        return torch.as_tensor(np.asarray(state[name], np.float32))

    def bn(dst, src):
        return {f"{dst}.scale": t(f"{src}.weight"),
                f"{dst}.offset": t(f"{src}.bias"),
                f"{dst}.mean": t(f"{src}.running_mean"),
                f"{dst}.var": t(f"{src}.running_var")}

    out = {"conv1": t("conv1.weight"), **bn("bn1", "bn1")}
    for li, n_blocks in enumerate(BLOCKS[depth]):
        for b in range(n_blocks):
            src, dst = f"layer{li + 1}.{b}", f"layers.{li}.{b}"
            for k in (1, 2, 3):
                out[f"{dst}.conv{k}"] = t(f"{src}.conv{k}.weight")
                out.update(bn(f"{dst}.bn{k}", f"{src}.bn{k}"))
            if f"{src}.downsample.0.weight" in state:
                out[f"{dst}.downsample.conv"] = t(f"{src}.downsample.0.weight")
                out.update(bn(f"{dst}.downsample.bn", f"{src}.downsample.1"))
    return out


__all__ = ["BLOCKS", "IMAGENET_MEAN", "IMAGENET_STD", "ResNet",
           "convert_torchvision_state_dict", "preprocess_images"]
