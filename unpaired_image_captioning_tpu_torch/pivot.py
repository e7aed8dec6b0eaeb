"""Language-pivot inference: image -> zh caption (beam) -> en translation
(beam) (counterpart of `unpaired_image_captioning_tpu/pivot.py`).

The captioner's decoded zh ids map to NMT source ids with one gather
through a dense id table and flow straight into the NMT encoder, with no
host hop. `post_edit` turns the result into English text on the host, as
`PivotService` and `eval_split_coco_unpaired` both serve it.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import constants as C
from .vocab import CaptionVocab, Dict


def build_joint_vocab(cap_vocab: CaptionVocab, nmt_dict: Dict
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Rows (cap_ix, nmt_ix) for every surface form present in both
    vocabs, as two aligned int32 index arrays."""
    cap_rows, nmt_rows = [], []
    for ix_str, word in cap_vocab.ix_to_word.items():
        j = nmt_dict.lookup(word)
        if j is not None:
            cap_rows.append(int(ix_str))
            nmt_rows.append(int(j))
    return (np.asarray(cap_rows, np.int32), np.asarray(nmt_rows, np.int32))


def build_caption_to_nmt_map(cap_vocab: CaptionVocab, nmt_src_dict: Dict
                             ) -> np.ndarray:
    """Dense id map [cap_vocab+1] -> nmt src id (UNK where missing, 0->PAD)."""
    table = np.full((cap_vocab.vocab_size + 1,), C.UNK, np.int32)
    table[0] = C.PAD
    for ix_str, word in cap_vocab.ix_to_word.items():
        j = nmt_src_dict.lookup(word)
        if j is not None:
            table[int(ix_str)] = int(j)
    return table


def captions_to_nmt_batch(cap_seqs: torch.Tensor, cap2nmt: torch.Tensor, *,
                          add_bos_eos: bool = False):
    """Map decoded caption ids [B, T] (0-terminated) to an NMT batch
    (src, lengths) through the dense id map. With `add_bos_eos` the result
    is wrapped with BOS/EOS for use as an NMT target."""
    src = cap2nmt[cap_seqs].long()
    lengths = torch.clamp((cap_seqs > 0).sum(-1), min=1)
    if not add_bos_eos:
        return src, lengths
    b, t = src.shape
    out = torch.zeros((b, t + 2), dtype=src.dtype, device=src.device)
    out[:, 0] = C.BOS
    out[:, 1:-1] = src
    pos = torch.arange(t + 2, device=src.device)[None, :]
    end = (lengths + 1)[:, None]
    out = torch.where(pos == end, torch.full_like(out, C.EOS), out)
    out = torch.where(pos > end, torch.full_like(out, C.PAD), out)
    return out, lengths + 2


@torch.inference_mode()
def pivot_translate(cap_model, nmt_model, feats, cap2nmt: torch.Tensor, *,
                    cap_beam: int = 5, nmt_beam: int = 15,
                    nmt_max_len: int = 100, src2tgt=None):
    """Image features -> zh caption (beam) -> en translation (beam).
    Returns (zh_seq [B, Tc], en_seq [B, Tn], en_attn_argmax [B, Tn]).

    src2tgt: an optional Dict.align map; with a copy-attention NMT the
    translation beam then runs over the extended vocab, and en_seq comes
    back collapsed (exact copies as UNK), with each copy's source position
    in place of the attention argmax: exact copies win."""
    res = cap_model.sample_beam(feats, beam_size=cap_beam)
    zh = res.seq[:, 0]                                     # top beam [B, Tc]
    src, lengths = captions_to_nmt_batch(zh, cap2nmt)      # cap2nmt[0] = PAD
    tr = nmt_model.translate_batch(src, lengths, beam_size=nmt_beam,
                                   max_len=nmt_max_len, src2tgt=src2tgt)
    en, aux = tr.seq[:, 0], tr.aux[:, 0]
    if src2tgt is not None and getattr(nmt_model, "copy_attn", False):
        en, copy_pos = nmt_model.resolve_extended(en)
        aux = torch.where(copy_pos >= 0, copy_pos, aux)
    return zh, en, aux


def post_edit(zh, en, attn, zh_vocab: dict, nmt_tgt_itos: dict, *,
              replace_unk: bool = True):
    """The pivot's host post-edit (JAX `eval/eval_utils.py:358-383`):
    zh [B, Tc], en [B, Tn] and attn [B, Tn] ids (numpy) of
    `pivot_translate` -> (zh captions, en captions). An en row stops at PAD
    or EOS and skips BOS; with `replace_unk`, UNK becomes the zh word at the
    attention argmax (source slot j is zh caption slot j); then contractions
    are expanded."""
    from .utils.text import decode_sequence, expand_contractions

    zh_caps = decode_sequence(zh_vocab, zh)
    en_caps = []
    for bi in range(zh.shape[0]):
        words = []
        for t, tok in enumerate(en[bi]):
            tok = int(tok)
            if tok in (C.PAD, C.EOS):
                break
            if tok == C.BOS:
                continue
            if tok == C.UNK and replace_unk:
                j = int(attn[bi, t])
                src_tok = int(zh[bi, j]) if j < zh.shape[1] else 0
                words.append(zh_vocab.get(str(src_tok),
                                          zh_vocab.get(src_tok, C.UNK_WORD)))
            else:
                words.append(nmt_tgt_itos.get(tok, C.UNK_WORD))
        en_caps.append(expand_contractions(" ".join(words)))
    return zh_caps, en_caps
