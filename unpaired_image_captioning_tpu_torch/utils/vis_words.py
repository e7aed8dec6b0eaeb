"""Word-frequency scatter visualization (the port's copy of
`unpaired_image_captioning_tpu/utils/vis_words.py`).

Parity: reference `misc/vis_words.py:12-25` (scattertext) — compare word
usage between two caption corpora (e.g. generated vs ground truth) as an
interactive-ish scatter: x = frequency in corpus A, y = frequency in
corpus B, hover titles with counts. Dependency-free SVG/HTML.
"""

from __future__ import annotations

import html
import math
import os
from collections import Counter
from typing import List


def vis_words(corpus_a: List[str], corpus_b: List[str], out_path: str, *,
              label_a: str = "corpus A", label_b: str = "corpus B",
              top_k: int = 300, size: int = 640) -> str:
    ca = Counter(w for s in corpus_a for w in s.split())
    cb = Counter(w for s in corpus_b for w in s.split())
    words = [w for w, _ in (ca + cb).most_common(top_k)]
    max_a = max((ca[w] for w in words), default=1)
    max_b = max((cb[w] for w in words), default=1)

    def sx(v, m):
        return 40 + (size - 80) * math.log1p(v) / math.log1p(max(m, 1))

    pts = []
    for w in words:
        x = sx(ca[w], max_a)
        y = size - sx(cb[w], max_b)
        # diagonal distance decides color: A-heavy red, B-heavy blue
        bias = (ca[w] / max(max_a, 1)) - (cb[w] / max(max_b, 1))
        color = "#d62728" if bias > 0.02 else ("#1f77b4" if bias < -0.02
                                               else "#7f7f7f")
        title = html.escape(f"{w}: {label_a}={ca[w]} {label_b}={cb[w]}")
        pts.append(
            f'<circle cx="{x:.1f}" cy="{y:.1f}" r="3" fill="{color}" '
            f'fill-opacity="0.6"><title>{title}</title></circle>')
        if ca[w] + cb[w] >= (max_a + max_b) * 0.15:  # label the heavy hitters
            pts.append(f'<text x="{x + 4:.1f}" y="{y - 3:.1f}" font-size="9" '
                       f'font-family="sans-serif">{html.escape(w)}</text>')

    svg = (
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{size}" height="{size}" '
        f'style="background:#fff">'
        f'<line x1="40" y1="{size - 40}" x2="{size - 40}" y2="40" '
        f'stroke="#ddd"/>'
        f'<text x="{size // 2}" y="{size - 8}" font-size="12" '
        f'text-anchor="middle" font-family="sans-serif">{html.escape(label_a)} frequency →</text>'
        f'<text x="12" y="{size // 2}" font-size="12" text-anchor="middle" '
        f'font-family="sans-serif" transform="rotate(-90 12 {size // 2})">'
        f'{html.escape(label_b)} frequency →</text>'
        + "".join(pts) + "</svg>")
    doc = f"<!doctype html><html><body>{svg}</body></html>"
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w", encoding="utf-8") as f:
        f.write(doc)
    return out_path
