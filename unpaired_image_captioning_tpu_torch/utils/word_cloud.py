"""Word-cloud layout + SVG rendering (the port's copy of
`unpaired_image_captioning_tpu/utils/word_cloud.py`).

Parity role: reference `scripts/word_cloud/` (vendored amueller/word_cloud)
whose hot loop is the Cython `query_integral_image` kernel
(wordcloud/query_integral_image.pyx:1-34) — here the C++ kernel in
native/uic_native.cpp via `native.query_integral_image`. Rendering is
dependency-free SVG (the reference renders with PIL fonts); occupancy is
approximated with glyph bounding boxes.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import native

# rough monospace glyph metrics for bounding boxes
_CHAR_W = 0.62  # width/height ratio per character


def layout_words(frequencies: Dict[str, float], *, width: int = 400,
                 height: int = 200, max_font_size: int = 64,
                 min_font_size: int = 8, margin: int = 2,
                 seed: int = 0) -> List[Tuple[str, int, int, int]]:
    """Greedy largest-first placement. Returns [(word, font, x, y)] with
    (x, y) the top-left corner."""
    if not frequencies:
        return []
    rng = np.random.RandomState(seed)
    items = sorted(frequencies.items(), key=lambda kv: -kv[1])
    fmax = items[0][1]
    occupancy = np.zeros((height, width), np.uint32)
    placed = []
    font = max_font_size
    for word, freq in items:
        target = int(max_font_size * (freq / fmax) ** 0.5)
        font = min(font, max(target, min_font_size))
        while font >= min_font_size:
            box_h = font + margin
            box_w = int(len(word) * font * _CHAR_W) + margin
            if box_h < height and box_w < width:
                integral = occupancy.cumsum(0).cumsum(1).astype(np.uint32)
                pos = native.query_integral_image(
                    integral, box_h, box_w, int(rng.randint(0, 2 ** 31 - 1)))
                if pos is not None:
                    x, y = pos  # row, col
                    occupancy[x: x + box_h, y: y + box_w] = 1
                    placed.append((word, font, y, x))
                    break
            font -= 4
        if font < min_font_size:
            break
    return placed


_PALETTE = ["#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd",
            "#8c564b", "#e377c2", "#7f7f7f", "#bcbd22", "#17becf"]


def render_svg(placed: List[Tuple[str, int, int, int]], *, width: int = 400,
               height: int = 200, out_path: Optional[str] = None) -> str:
    parts = [f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
             f'height="{height}" style="background:#fff">']
    for i, (word, font, x, y) in enumerate(placed):
        color = _PALETTE[i % len(_PALETTE)]
        parts.append(
            f'<text x="{x}" y="{y + font}" font-size="{font}" '
            f'font-family="monospace" fill="{color}">{word}</text>')
    parts.append("</svg>")
    svg = "\n".join(parts)
    if out_path:
        with open(out_path, "w", encoding="utf-8") as f:
            f.write(svg)
    return svg


def word_cloud_from_captions(captions: List[str], out_path: str,
                             top_k: int = 60, **kw) -> str:
    """Parity role: misc/vis_words.py word-frequency visualization."""
    from collections import Counter

    counts = Counter(w for c in captions for w in c.split())
    freqs = dict(counts.most_common(top_k))
    placed = layout_words(freqs, **kw)
    return render_svg(placed, out_path=out_path,
                      width=kw.get("width", 400), height=kw.get("height", 200))
