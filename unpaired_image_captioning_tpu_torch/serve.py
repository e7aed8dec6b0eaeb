"""Serving runtime: micro-batched caption and pivot services on the port's
models (counterpart of `unpaired_image_captioning_tpu/serve.py`).

The request queue (`MicroBatcher`) and the stdlib HTTP front end
(`make_http_server`: `POST /caption`, `POST /pivot`, `GET /stats`) are the
JAX package's own, imported: that module's top level needs only the
standard library and numpy. Each micro-batch is uploaded to the models'
device as f32 and decoded under `torch.inference_mode()` on the batcher's
thread.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from unpaired_image_captioning_tpu import constants as C
from unpaired_image_captioning_tpu.serve import MicroBatcher, make_http_server
from unpaired_image_captioning_tpu.utils.text import (decode_sequence,
                                                      expand_contractions)

from .models.base import Features
from .pivot import pivot_translate

__all__ = ["CaptionService", "MicroBatcher", "PivotService",
           "make_http_server"]


def _features(stacked: dict, device: torch.device) -> Features:
    def up(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return Features(fc_feats=up(stacked["fc"]), att_feats=up(stacked["att"]),
                    att_masks=up(stacked["masks"]))


def _submit(batcher: MicroBatcher, fc, att, masks, timeout: float):
    if masks is None:
        masks = np.ones(np.shape(att)[:1], np.float32)
    fut = batcher.submit({"fc": np.asarray(fc, np.float32),
                          "att": np.asarray(att, np.float32),
                          "masks": np.asarray(masks, np.float32)})
    return fut.result(timeout=timeout)


class CaptionService:
    """Feature-in, caption-out service around the beam decode."""

    def __init__(self, model, vocab_ix_to_word: dict, *, beam_size: int = 3,
                 max_batch: int = 32, max_wait_ms: float = 5.0,
                 greedy: bool = False):
        if greedy or beam_size == 1:
            raise NotImplementedError(
                "greedy sampling is not ported yet (ROADMAP A4)")
        self.model = model
        self.vocab = vocab_ix_to_word
        device = model.device

        def decode_batch(stacked: dict) -> List[str]:
            with torch.inference_mode():
                feats = _features(stacked, device)
                seq = model.sample_beam(feats, beam_size=beam_size).seq[:, 0]
            return decode_sequence(self.vocab, seq.cpu().numpy())

        self._decode_batch = decode_batch
        self.batcher = MicroBatcher(decode_batch, max_batch=max_batch,
                                    max_wait_ms=max_wait_ms)

    def caption(self, fc: np.ndarray, att: np.ndarray,
                masks: Optional[np.ndarray] = None,
                timeout: float = 30.0) -> str:
        return _submit(self.batcher, fc, att, masks, timeout)

    def close(self):
        self.batcher.close()


class PivotService:
    """Feature-in, (zh caption, en caption)-out service: the headline
    unpaired task (caption beam -> id remap -> NMT beam) per micro-batch,
    with UNK -> attention-argmax surface replacement and contraction
    expansion on the way out."""

    def __init__(self, cap_model, nmt_model, zh_vocab: dict,
                 nmt_tgt_itos: dict, cap2nmt, *, cap_beam: int = 5,
                 nmt_beam: int = 15, nmt_max_len: int = 20,
                 max_batch: int = 32, max_wait_ms: float = 5.0,
                 replace_unk: bool = True):
        device = cap_model.device
        cap2nmt_t = torch.as_tensor(np.asarray(cap2nmt), dtype=torch.int64,
                                    device=device)

        def decode_batch(stacked: dict) -> List[dict]:
            with torch.inference_mode():
                feats = _features(stacked, device)
                zh, en, attn = pivot_translate(
                    cap_model, nmt_model, feats, cap2nmt_t,
                    cap_beam=cap_beam, nmt_beam=nmt_beam,
                    nmt_max_len=nmt_max_len)
                zh_np, en_np = zh.cpu().numpy(), en.cpu().numpy()
                attn_np = attn.cpu().numpy()
            zh_caps = decode_sequence(zh_vocab, zh_np)
            outs = []
            for bi in range(zh_np.shape[0]):
                words = []
                for t, tok in enumerate(en_np[bi]):
                    tok = int(tok)
                    if tok in (C.PAD, C.EOS):
                        break
                    if tok == C.BOS:
                        continue
                    if tok == C.UNK and replace_unk:
                        j = int(attn_np[bi, t])
                        src_tok = int(zh_np[bi, j]) if j < zh_np.shape[1] else 0
                        words.append(zh_vocab.get(str(src_tok),
                                                  zh_vocab.get(src_tok,
                                                               C.UNK_WORD)))
                    else:
                        words.append(nmt_tgt_itos.get(tok, C.UNK_WORD))
                outs.append({"zh": zh_caps[bi],
                             "en": expand_contractions(" ".join(words))})
            return outs

        self._decode_batch = decode_batch
        self.batcher = MicroBatcher(decode_batch, max_batch=max_batch,
                                    max_wait_ms=max_wait_ms)

    def pivot(self, fc: np.ndarray, att: np.ndarray,
              masks: Optional[np.ndarray] = None,
              timeout: float = 60.0) -> dict:
        return _submit(self.batcher, fc, att, masks, timeout)

    def close(self):
        self.batcher.close()
