"""Merge and tokenize AIC annotation JSONs and assign train / val / test
splits (the port's copy of
`unpaired_image_captioning_tpu/scripts/prepro_split_tokenize.py`):

    python -m unpaired_image_captioning_tpu_torch.scripts.prepro_split_tokenize \\
        --inputs caption_train.json caption_val.json --output raw.json \\
        --num_val 10000 --num_test 10000

Parity: reference `scripts/prepro_split_tokenize.py` — merge the train and
val annotation files, segment Chinese captions with jieba (:37-41), a soft
dependency here: without it each non-ASCII character is a word and ASCII
words stay whole (a standard zh baseline). The zh route of
`eval/eval_utils.py::language_eval` segments every caption through
`segment_zh` too. The split is a seeded shuffle: the first `num_val`
images are val, the next `num_test` test, the rest train.

Input: AIC-style [{"image_id": str, "caption": [str, ...]}, ...].
Output: [{"id", "split", "file_path", "captions"}] consumable by
prepro_labels.
"""

from __future__ import annotations

import argparse
import json
import random
from typing import List


def segment_zh(text: str) -> List[str]:
    try:
        import jieba  # soft dep (reference vendors it)

        return [w for w in jieba.cut(text.strip()) if w.strip()]
    except ImportError:
        # per-character fallback: ascii words kept whole
        out, cur = [], ""
        for ch in text.strip():
            if ch.isascii() and (ch.isalnum() or ch in "'-"):
                cur += ch
            else:
                if cur:
                    out.append(cur)
                    cur = ""
                if not ch.isspace():
                    out.append(ch)
        if cur:
            out.append(cur)
        return out


def main(argv=None):
    p = argparse.ArgumentParser("prepro_split_tokenize")
    p.add_argument("--inputs", nargs="+", required=True,
                   help="AIC annotation jsons to merge")
    p.add_argument("--output", required=True)
    p.add_argument("--num_val", type=int, default=10000)
    p.add_argument("--num_test", type=int, default=10000)
    p.add_argument("--seed", type=int, default=123)
    a = p.parse_args(argv)

    anns = []
    for path in a.inputs:
        with open(path, encoding="utf-8") as f:
            anns.extend(json.load(f))

    # a generator of its own: the order of random.seed + random.shuffle
    # without touching the process's global generator
    random.Random(a.seed).shuffle(anns)
    out = []
    for i, ann in enumerate(anns):
        split = ("val" if i < a.num_val
                 else "test" if i < a.num_val + a.num_test else "train")
        caps = ann.get("caption") or ann.get("captions") or []
        if isinstance(caps, str):
            caps = [caps]
        out.append({
            "id": i,
            "split": split,
            "file_path": ann.get("image_id", ann.get("file_path", str(i))),
            "captions": [segment_zh(c) for c in caps],
        })
    with open(a.output, "w", encoding="utf-8") as f:
        json.dump(out, f, ensure_ascii=False)
    print(f"wrote {a.output}: {len(out)} images "
          f"({a.num_val} val / {a.num_test} test)")


if __name__ == "__main__":
    main()
