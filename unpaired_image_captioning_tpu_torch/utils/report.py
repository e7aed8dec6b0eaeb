"""HTML caption report (the port's copy of
`unpaired_image_captioning_tpu/utils/report.py`).

Parity: reference `misc/utils.py:231-266` html report generator and the
`vis/index.html` caption browser — a self-contained html page listing
images with their generated (and optionally reference) captions.
"""

from __future__ import annotations

import html
import os
from typing import Dict, List, Optional


def html_report(predictions: List[dict], out_path: str,
                references: Optional[Dict] = None,
                title: str = "captions") -> str:
    rows = []
    for p in predictions:
        iid = p["image_id"]
        cap = html.escape(p["caption"])
        img_tag = ""
        fp = p.get("file_path", "")
        if fp:
            img_tag = f'<img src="{html.escape(fp)}" width="224"><br>'
        ref_html = ""
        if references and iid in references:
            refs = "".join(f"<li>{html.escape(r)}</li>"
                           for r in references[iid])
            ref_html = f"<ul class=refs>{refs}</ul>"
        rows.append(
            f'<div class=item>{img_tag}<b>{iid}</b>: {cap}{ref_html}</div>')
    doc = (
        "<!doctype html><html><head><meta charset='utf-8'>"
        f"<title>{html.escape(title)}</title>"
        "<style>.item{margin:12px;padding:8px;border-bottom:1px solid #ccc}"
        ".refs{color:#666;font-size:90%}</style></head><body>"
        f"<h1>{html.escape(title)}</h1>" + "\n".join(rows) + "</body></html>")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w", encoding="utf-8") as f:
        f.write(doc)
    return out_path
