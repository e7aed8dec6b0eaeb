"""Convert bottom-up-attention TSVs to per-image feature files (the port's
copy of `unpaired_image_captioning_tpu/scripts/make_bu_data.py`):

    python -m unpaired_image_captioning_tpu_torch.scripts.make_bu_data \\
        --input_tsvs trainval.tsv --output_dir data/bu

Parity: reference `scripts/make_bu_data.py` — read the bottom-up TSV
(base64-encoded float32 box features and boxes), write `bu_fc/<id>.npy`
(mean-pooled), `bu_att/<id>.npz` (box features under `feat`) and
`bu_box/<id>.npy` (box coords): the dirs `cli.train` reads with
`--input_fc_dir` / `--input_att_dir` / `--input_box_dir`.
"""

from __future__ import annotations

import argparse
import base64
import csv
import os
import sys

import numpy as np

FIELDNAMES = ["image_id", "image_w", "image_h", "num_boxes", "boxes",
              "features"]


def main(argv=None):
    p = argparse.ArgumentParser("make_bu_data")
    p.add_argument("--input_tsvs", nargs="+", required=True)
    p.add_argument("--output_dir", default="data/bu")
    p.add_argument("--feat_dim", type=int, default=2048)
    a = p.parse_args(argv)

    for sub in ("_fc", "_att", "_box"):
        os.makedirs(a.output_dir + sub, exist_ok=True)

    csv.field_size_limit(sys.maxsize)
    n = 0
    for tsv in a.input_tsvs:
        with open(tsv, "r", newline="") as f:
            reader = csv.DictReader(f, delimiter="\t", fieldnames=FIELDNAMES)
            for row in reader:
                num_boxes = int(row["num_boxes"])
                feats = np.frombuffer(
                    base64.b64decode(row["features"]), np.float32
                ).reshape(num_boxes, a.feat_dim)
                boxes = np.frombuffer(
                    base64.b64decode(row["boxes"]), np.float32
                ).reshape(num_boxes, 4)
                iid = row["image_id"]
                np.save(os.path.join(a.output_dir + "_fc", f"{iid}.npy"),
                        feats.mean(0))
                np.savez_compressed(
                    os.path.join(a.output_dir + "_att", f"{iid}.npz"),
                    feat=feats)
                np.save(os.path.join(a.output_dir + "_box", f"{iid}.npy"),
                        boxes)
                n += 1
    print(f"converted {n} images")


if __name__ == "__main__":
    main()
