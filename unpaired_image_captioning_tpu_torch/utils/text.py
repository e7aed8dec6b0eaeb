"""Text utilities (the port's copy of the parts of
`unpaired_image_captioning_tpu/utils/text.py` that serving uses).

Parity: reference `misc/utils.py` `decode_sequence` (:49-66): ids ->
strings, stop at 0; and a contraction expander standing in for
misc/expander/ ("'s"->"is" pivot post-edit, eval_utils.py:417-420).
"""

from __future__ import annotations

from typing import Dict, List

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


def expand_contractions(text: str) -> str:
    """Pivot post-edit (eval_utils.py:417-420): expand contractions with the
    full rule-based expander (misc/expander parity, utils/expander.py) and
    strip the leading "there is"."""
    from .expander import expand_sentence

    out = expand_sentence(text)
    if out.startswith("there is "):
        out = out[len("there is "):]
    return out.strip()
