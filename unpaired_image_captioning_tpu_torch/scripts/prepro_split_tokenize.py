"""Chinese caption segmentation (the `segment_zh` part of
`unpaired_image_captioning_tpu/scripts/prepro_split_tokenize.py`; its
merge-and-split `main` comes with the rest of `scripts/`, ROADMAP A9).

Parity: reference `scripts/prepro_split_tokenize.py:37-41` segments with
jieba, a soft dependency here: without it each non-ASCII character is a
word and ASCII words stay whole (a standard zh baseline). The zh route of
`eval/eval_utils.py::language_eval` segments every caption through it.
"""

from __future__ import annotations

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
