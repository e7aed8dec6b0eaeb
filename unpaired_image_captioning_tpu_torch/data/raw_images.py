"""Raw-image eval loader: folder of images -> on-the-fly ResNet features
(counterpart of `unpaired_image_captioning_tpu/data/raw_images.py`).

Parity: reference `misc/dataloader/dataloaderraw.py:25-141`: list the
images of a folder (or of a coco json), read them, run the ResNet forward a
batch at a time, emit the batch dict of the precomputed loaders. Reading
and the nearest-index resize to `image_size` stay on the host, as in the
JAX package (.npy arrays, or any format PIL reads).

One deliberate difference: normalisation moves to the card. The uint8
batch is uploaded as it is (4x fewer bytes than f32) and the image front
end (`kernels/image.py::resize_normalize`, at an unchanged size, where its
interpolation is the identity) computes `(x / 255 - mean) / std` there,
exactly the host's `preprocess_images`. The batch's tensors are on the
loader's device; `infos` and `bounds` are as in the JAX package.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np
import torch

from ..kernels.image import resize_normalize
from ..models.base import resolve_device
from ..models.resnet import ResNet

IMG_EXTS = (".jpg", ".jpeg", ".png", ".ppm", ".npy")


class RawImageLoader:
    def __init__(self, *, folder_path: str = "", coco_json: str = "",
                 batch_size: int = 16, att_size: int = 14,
                 resnet_params: Optional[dict] = None,
                 depth: str = "resnet101", image_size: int = 448,
                 seq_per_img: int = 1, device="cuda"):
        """`resnet_params` is a state dict of the port's ResNet
        (`convert_torchvision_state_dict`, `bridge.resnet_state_from_jax`);
        without one the weights are random from seed 0."""
        self.device = resolve_device(device)
        self.batch_size = batch_size
        self.att_size = att_size
        self.image_size = image_size
        self.seq_per_img = seq_per_img
        self.resnet = ResNet(depth, device=self.device)
        if resnet_params is None:
            self.resnet.init_params(
                torch.Generator(device=self.device).manual_seed(0))
        else:
            self.resnet.load_state_dict(resnet_params)

        self.files: List[str] = []
        self.ids: List = []
        if coco_json:
            with open(coco_json) as f:
                info = json.load(f)
            for img in info["images"]:
                self.files.append(img["file_path"] if "file_path" in img
                                  else img["file_name"])
                self.ids.append(img["id"])
        else:
            for n, fn in enumerate(sorted(os.listdir(folder_path))):
                if fn.lower().endswith(IMG_EXTS):
                    self.files.append(os.path.join(folder_path, fn))
                    self.ids.append(n)
        self.iterator = 0
        self.split_ix = {"val": list(range(len(self.files))),
                         "test": list(range(len(self.files)))}

    @property
    def vocab(self):  # set externally from the model's talk.json
        return self._vocab

    @vocab.setter
    def vocab(self, v):
        self._vocab = v

    def reset_iterator(self, split: str = "val"):
        self.iterator = 0

    def _read_image(self, path: str) -> np.ndarray:
        if path.endswith(".npy"):
            img = np.load(path)
        else:
            try:
                from PIL import Image  # optional dep

                img = np.asarray(Image.open(path).convert("RGB"))
            except ImportError as e:
                raise RuntimeError(
                    "PIL unavailable; supply .npy images or precomputed "
                    "features") from e
        if img.ndim == 2:
            img = np.stack([img] * 3, axis=-1)
        # center resize via simple numpy interpolation to image_size
        h, w = img.shape[:2]
        ys = (np.linspace(0, h - 1, self.image_size)).astype(np.int64)
        xs = (np.linspace(0, w - 1, self.image_size)).astype(np.int64)
        return img[ys][:, xs]

    def get_batch(self, split: str = "val", batch_size: Optional[int] = None):
        bs = batch_size or self.batch_size
        imgs, infos = [], []
        wrapped = False
        n = len(self.files)
        for _ in range(bs):
            if self.iterator >= n:
                self.iterator = 0
                wrapped = True
            i = self.iterator
            self.iterator += 1
            imgs.append(self._read_image(self.files[i]))
            infos.append({"ix": i, "id": self.ids[i],
                          "file_path": self.files[i]})
        # np.stack keeps the fancy-indexed images' axis order: make it C
        host = np.ascontiguousarray(np.stack(imgs))
        if host.dtype != np.uint8:
            raise ValueError(f"RawImageLoader: images must be uint8, got "
                             f"{host.dtype}")
        x = torch.from_numpy(host).to(self.device)
        x = resize_normalize(x, h_out=self.image_size, w_out=self.image_size)
        with torch.no_grad():
            fc, att = self.resnet.my_resnet(x, att_size=self.att_size)
        att = att.reshape(bs, -1, att.shape[-1]).contiguous()
        dev = self.device
        return {
            "fc_feats": fc,
            "att_feats": att,
            "attri_feats": torch.zeros((bs, 1601), device=dev),
            "att_masks": torch.ones(att.shape[:2], device=dev),
            "labels": torch.zeros((bs, 18), dtype=torch.int32, device=dev),
            "masks": torch.zeros((bs, 18), device=dev),
            "infos": infos,
            "bounds": {"it_pos_now": self.iterator, "it_max": n,
                       "wrapped": wrapped},
        }
