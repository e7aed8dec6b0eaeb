"""Build the caption vocabulary and label tensors (the port's copy of
`unpaired_image_captioning_tpu/scripts/prepro_labels.py`):

    python -m unpaired_image_captioning_tpu_torch.scripts.prepro_labels \\
        --input_json raw.json --output_json talk.json \\
        --output_h5 label.npz --word_count_threshold 5

Parity: reference `scripts/prepro_labels.py` (zh, UNK='卍') and
`prepro_labels_coco.py` (en, UNK='UNK') — word-count-threshold vocab,
captions encoded to `labels [M, max_length]` int32 with
`label_start_ix`/`label_end_ix` (1-indexed) and `label_length`; outputs
`<name>_talk.json` (ix_to_word + images) and the label file. The flag
keeps its JAX name, `--output_h5`; the file is written by its suffix
(`data/arrays.py::write_arrays`): `.npz` needs only numpy, any other
suffix is HDF5.

Input json format: [{"id": int, "split": str, "file_path": str,
"captions": [[tok, ...], ...]}].
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from .. import constants as C
from ..data.arrays import write_arrays
from ..vocab import CaptionVocab


def build(input_json: str, output_json: str, output_h5: str, *,
          max_length: int = 20, word_count_threshold: int = 5,
          unk_word: str = C.ZH_UNK_WORD) -> CaptionVocab:
    with open(input_json, encoding="utf-8") as f:
        images = json.load(f)

    vocab = CaptionVocab.build(
        (cap for img in images for cap in img["captions"]),
        count_threshold=word_count_threshold, unk_word=unk_word)
    print(f"vocab size {vocab.vocab_size} (threshold {word_count_threshold})")

    labels, start, end, lengths = [], [], [], []
    pos = 1
    out_images = []
    for img in images:
        start.append(pos)
        for cap in img["captions"]:
            labels.append(vocab.encode(cap, max_length))
            lengths.append(min(len(cap), max_length))
            pos += 1
        end.append(pos - 1)
        out_images.append({k: img[k] for k in ("id", "split", "file_path")
                           if k in img})

    write_arrays(output_h5, {
        "labels": np.stack(labels),
        "label_start_ix": np.asarray(start, np.int64),
        "label_end_ix": np.asarray(end, np.int64),
        "label_length": np.asarray(lengths, np.int64)})
    with open(output_json, "w", encoding="utf-8") as f:
        json.dump({"ix_to_word": vocab.ix_to_word, "images": out_images}, f)
    print(f"wrote {output_json} and {output_h5} "
          f"({len(labels)} captions, {len(out_images)} images)")
    return vocab


def main(argv=None):
    p = argparse.ArgumentParser("prepro_labels")
    p.add_argument("--input_json", required=True)
    p.add_argument("--output_json", required=True)
    p.add_argument("--output_h5", required=True,
                   help="the label file: .npz, or HDF5 for any other suffix")
    p.add_argument("--max_length", type=int, default=20)
    p.add_argument("--word_count_threshold", type=int, default=5)
    p.add_argument("--unk_word", default=C.ZH_UNK_WORD)
    a = p.parse_args(argv)
    build(a.input_json, a.output_json, a.output_h5, max_length=a.max_length,
          word_count_threshold=a.word_count_threshold, unk_word=a.unk_word)


if __name__ == "__main__":
    main()
