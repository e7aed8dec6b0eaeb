"""Offline ResNet feature extraction (counterpart of
`unpaired_image_captioning_tpu/scripts/prepro_feats.py`).

Parity: reference `scripts/prepro_feats.py:54-95`: ResNet-101/152 forward,
save `fc` (.npy, 2048) and `att` (.npz, 14x14x2048) per image id, a batch
at a time on the card (`--device`, default cuda):

    python -m unpaired_image_captioning_tpu_torch.scripts.prepro_feats \\
        --input_json images.json --output_dir data/feats

writes `data/feats_fc/{id}.npy` and `data/feats_att/{id}.npz`. Without
`--model_weights` (a torchvision .pth state dict) the weights are random
from seed 0.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def main(argv=None):
    import torch

    from ..data.raw_images import RawImageLoader
    from ..models.resnet import convert_torchvision_state_dict

    p = argparse.ArgumentParser("prepro_feats")
    p.add_argument("--input_json", required=True,
                   help="[{id, file_path}, ...] image list")
    p.add_argument("--images_root", default="")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--att_size", type=int, default=14)
    p.add_argument("--model", default="resnet101")
    p.add_argument("--model_weights", default="",
                   help="optional torchvision .pth state_dict")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--device", default="cuda",
                   help="where the ResNet runs (cuda, or cpu)")
    a = p.parse_args(argv)

    if a.model_weights:
        state = torch.load(a.model_weights, map_location="cpu",
                           weights_only=True)
        params = convert_torchvision_state_dict(
            {k: v.numpy() for k, v in state.items()}, a.model)
    else:
        params = None
        print("WARNING: random ResNet weights (no --model_weights given)")

    with open(a.input_json) as f:
        images = json.load(f)
    if isinstance(images, dict):
        images = images["images"]

    os.makedirs(os.path.join(a.output_dir + "_fc"), exist_ok=True)
    os.makedirs(os.path.join(a.output_dir + "_att"), exist_ok=True)

    loader = RawImageLoader(coco_json=a.input_json, batch_size=a.batch_size,
                            att_size=a.att_size, resnet_params=params,
                            depth=a.model, device=a.device)
    done = 0
    while done < len(images):
        batch = loader.get_batch()
        fc = batch["fc_feats"].cpu().numpy()
        att = batch["att_feats"].cpu().numpy()
        for bi, info in enumerate(batch["infos"]):
            if done >= len(images):
                break
            np.save(os.path.join(a.output_dir + "_fc", f"{info['id']}.npy"),
                    fc[bi])
            np.savez_compressed(
                os.path.join(a.output_dir + "_att", f"{info['id']}.npz"),
                feat=att[bi].reshape(a.att_size, a.att_size, -1))
            done += 1
        print(f"{done}/{len(images)}")
    print("done")


if __name__ == "__main__":
    main()
