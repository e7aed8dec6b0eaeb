"""Weight surgery: resume and cross-model transplant (counterpart of
`unpaired_image_captioning_tpu/models/weight_init.py`).

Parameters are matched by path, the state dict's dot-joined key (the JAX
package joins the same names with "/"): every donor tensor whose path and
shape agree with the fresh model's is copied in, the rest keep their fresh
values, and a report of transplanted / skipped paths comes back for the
log.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch


def transplant(fresh: Dict[str, torch.Tensor],
               donor: Dict[str, torch.Tensor], *, strict: bool = False,
               rename: Dict[str, str] | None = None
               ) -> Tuple[Dict[str, torch.Tensor], List[str], List[str]]:
    """Copy every donor tensor whose path and shape match into a copy of
    the state dict `fresh`.

    rename: donor-path-prefix -> fresh-path-prefix map for surgery across
    architectures (e.g. {"core.lstm0": "core.att_lstm"}); the first prefix
    that matches applies.
    Returns (state dict, transplanted paths, skipped paths), the paths in
    `fresh`'s order.
    """
    if rename:
        renamed = {}
        for path, leaf in donor.items():
            for src, dst in rename.items():
                if path.startswith(src):
                    path = dst + path[len(src):]
                    break
            renamed[path] = leaf
        donor = renamed
    out, transplanted, skipped = {}, [], []
    for path, leaf in fresh.items():
        d = donor.get(path)
        if d is not None and tuple(d.shape) == tuple(leaf.shape):
            transplanted.append(path)
            out[path] = torch.as_tensor(d).to(dtype=leaf.dtype,
                                              device=leaf.device).clone()
            continue
        skipped.append(path)
        if strict and d is not None:
            raise ValueError(f"shape mismatch at {path}: donor "
                             f"{tuple(d.shape)} vs fresh {tuple(leaf.shape)}")
        out[path] = leaf
    return out, transplanted, skipped


def partial_embedding_transplant(fresh_emb: torch.Tensor, donor_emb,
                                 row_map) -> torch.Tensor:
    """Copy donor embedding rows into fresh rows through an index map (the
    StackCap surgery and resumes across vocabularies).

    row_map: int array [K, 2] of (fresh_row, donor_row) pairs. Returns a
    new tensor; `fresh_emb` is left alone.
    """
    rows = torch.as_tensor(row_map, dtype=torch.long,
                           device=fresh_emb.device)
    out = fresh_emb.detach().clone()
    donor = torch.as_tensor(donor_emb).to(dtype=fresh_emb.dtype,
                                          device=fresh_emb.device)
    out[rows[:, 0]] = donor[rows[:, 1]]
    return out
