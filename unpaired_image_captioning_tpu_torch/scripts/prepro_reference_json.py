"""Build the zh evaluation reference JSON for the AIC scorer (the port's
copy of `unpaired_image_captioning_tpu/scripts/prepro_reference_json.py`):

    python -m unpaired_image_captioning_tpu_torch.scripts.prepro_reference_json \\
        --input_json talk.json --input_label_h5 label.npz \\
        --output val_refs.json --split val

Parity: reference `scripts/prepro_reference_json.py` — convert the split's
ground-truth captions into the COCO-annotation shape consumed by the zh
metric stack ({'annotations': [{'image_id', 'id', 'caption'}], 'images':
[...], 'type': 'captions'}). The labels are read by their suffix
(`data/arrays.py`): `.npz` or HDF5.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    from ..data.arrays import read_arrays
    from ..vocab import CaptionVocab

    p = argparse.ArgumentParser("prepro_reference_json")
    p.add_argument("--input_json", required=True)
    p.add_argument("--input_label_h5", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--split", default="val")
    a = p.parse_args(argv)

    with open(a.input_json, encoding="utf-8") as f:
        info = json.load(f)
    vocab = CaptionVocab(info["ix_to_word"])
    arrays = read_arrays(a.input_label_h5)
    labels = arrays["labels"]
    start = arrays["label_start_ix"]
    end = arrays["label_end_ix"]

    images, annotations = [], []
    ann_id = 0
    for ix, img in enumerate(info["images"]):
        if img.get("split", "train") != a.split:
            continue
        iid = img.get("id", ix)
        images.append({"id": iid, "file_name": img.get("file_path", "")})
        for cap in vocab.decode_sequence(labels[start[ix] - 1: end[ix]]):
            annotations.append({"image_id": iid, "id": ann_id, "caption": cap})
            ann_id += 1
    with open(a.output, "w", encoding="utf-8") as f:
        json.dump({"images": images, "annotations": annotations,
                   "type": "captions", "licenses": [], "info": {}},
                  f, ensure_ascii=False)
    print(f"wrote {a.output}: {len(images)} images, {ann_id} references")


if __name__ == "__main__":
    main()
