"""Text utilities (the port's copy of
`unpaired_image_captioning_tpu/utils/text.py`).

Parity: reference `misc/utils.py` —
- `decode_sequence` (:49-66): ids -> strings, stop at 0;
- self-BLEU diversity metric (:85-103, misc/cal_self_bleu.py);
- caption json <-> text converters (:119-161, :220-228), the stages of the
  staged pivot eval (`cli/eval_pivot.py`) and the flickr30k route;
- a contraction expander standing in for misc/expander/ ("'s"->"is" pivot
  post-edit, eval_utils.py:417-420).
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

import numpy as np


def decode_sequence(ix_to_word: Dict[str, str], seq, join_with: str = " "
                    ) -> List[str]:
    """ids [N, D] -> N strings, stopping at the first 0 (misc/utils.py:49-66)."""
    seq = np.asarray(seq)
    if seq.ndim == 1:
        seq = seq[None]
    out = []
    for row in seq:
        words = []
        for ix in row:
            ix = int(ix)
            if ix == 0:
                break
            words.append(ix_to_word.get(str(ix), ""))
        out.append(join_with.join(words))
    return out


def cocojson2text(json_path: str, txt_path: str) -> None:
    """predictions json [{image_id, caption}] -> one caption per line."""
    with open(json_path) as f:
        preds = json.load(f)
    with open(txt_path, "w", encoding="utf-8") as f:
        for p in preds:
            f.write(p["caption"].strip() + "\n")


def json2text(json_path: str, txt_path: str) -> None:
    """`cocojson2text` under the reference's other name."""
    cocojson2text(json_path, txt_path)


def text2textid(txt_path: str, ids: Sequence, out_path: str) -> None:
    """lines + image ids -> tsv id\\tcaption."""
    with open(txt_path, encoding="utf-8") as f:
        lines = [l.rstrip("\n") for l in f]
    with open(out_path, "w", encoding="utf-8") as f:
        for i, line in zip(ids, lines):
            f.write(f"{i}\t{line}\n")


def text2cocojson(txt_path: str, ids: Sequence, json_path: str) -> None:
    with open(txt_path, encoding="utf-8") as f:
        lines = [l.rstrip("\n") for l in f]
    preds = [{"image_id": i, "caption": line} for i, line in zip(ids, lines)]
    with open(json_path, "w") as f:
        json.dump(preds, f)


def expand_contractions(text: str) -> str:
    """Pivot post-edit (eval_utils.py:417-420): expand contractions with the
    full rule-based expander (misc/expander parity, utils/expander.py) and
    strip the leading "there is"."""
    from .expander import expand_sentence

    out = expand_sentence(text)
    if out.startswith("there is "):
        out = out[len("there is "):]
    return out.strip()


def self_bleu(sentences: List[str], n: int = 4, sample: Optional[int] = None
              ) -> float:
    """Self-BLEU diversity: mean sentence-BLEU of each caption against all
    others (misc/utils.py:85-103; lower = more diverse)."""
    from ..eval.metrics.bleu import sentence_bleu

    toks = [s.split() for s in sentences if s.strip()]
    if len(toks) < 2:
        return 0.0
    idxs = range(len(toks)) if sample is None else range(min(sample, len(toks)))
    scores = []
    for i in idxs:
        refs = toks[:i] + toks[i + 1:]
        scores.append(sentence_bleu(toks[i], refs, n=n))
    return float(np.mean(scores)) if scores else 0.0
