"""Guided-fertility tables from word alignments (counterpart of
`unpaired_image_captioning_tpu/utils/fertility.py`).

Parity: reference `misc/OpenNMT-py-dalegebit/evaluation.py:147-191`
(`get_fert_dict` + `getBatchFertilities`), the `-guided_fertility
<alignment file>` path of the fork's constrained attention: a
fast_align-style file ("i-j" source-target pairs per line, aligned with the
training source corpus) is folded into a per-WORD max-fertility table, then
looked up per batch token as the attention upper-bound init (fork
Models.py:463-470).

The reference's per-sentence fold reads `fertility_i[a]` with `a` left over
from the LAST alignment pair of the line (evaluation.py:173), a py2-era
indexing slip that makes every word of the sentence adopt the last-aligned
word's fertility. `alignment_fertilities` keeps the intended per-word max
(each word's own alignment count), as the JAX package does; the two
readings agree where each word of a line has one alignment.

Host-side preparation (runs once); feed `batch_fertilities(table, src)` as
`src_fertilities` to `NMTModel.forward` / `translate_batch`.
"""

from __future__ import annotations

import numpy as np


def alignment_fertilities(align_lines, src_id_lines, vocab_size: int,
                          default: float = 1.0) -> np.ndarray:
    """Fold alignment lines into a per-word max-fertility table.

    align_lines: iterable of "i-j i-j ..." strings (source index i ->
    target index j, fast_align format); src_id_lines: the matching
    tokenized source sentences as id lists. Returns float32 [vocab_size]
    with `default` for never-aligned words (getBatchFertilities
    default_fert, evaluation.py:176-191).
    """
    table = np.full((vocab_size,), default, np.float32)
    for line, ids in zip(align_lines, src_id_lines):
        fert = np.ones(len(ids), np.float32)
        for pair in line.split():
            a = int(pair.split("-")[0])
            if 0 <= a < len(fert):
                fert[a] += 1.0
        for pos, idx in enumerate(ids):
            if 0 <= idx < vocab_size:
                table[idx] = max(table[idx], float(fert[pos]))
    return table


def fert_table_from_files(align_path: str, train_src_path: str, src_dict,
                          default: float = 1.0) -> np.ndarray:
    """The file-level `get_fert_dict` (evaluation.py:147-173): tokenize the
    training source with `src_dict` (an onmt-style `vocab.Dict`), then
    fold the alignment file. Unknown words map to UNK's slot, as
    convertToIdx does."""
    from .. import constants as C

    with open(train_src_path, encoding="utf-8") as f:
        src_id_lines = [[src_dict.lookup(w, C.UNK) for w in line.split()]
                        for line in f]
    with open(align_path, encoding="utf-8") as f:
        align_lines = [line.strip() for line in f]
    return alignment_fertilities(align_lines, src_id_lines, src_dict.size(),
                                 default=default)


def batch_fertilities(table: np.ndarray, src_ids) -> np.ndarray:
    """The `getBatchFertilities` lookup (evaluation.py:176-191): per token,
    [B, S] float32, to feed as `src_fertilities` to the NMT model."""
    return np.asarray(table, np.float32)[np.asarray(src_ids)]
