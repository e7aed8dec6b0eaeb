"""Serving runtime: micro-batched caption and pivot services on the port's
models (counterpart of `unpaired_image_captioning_tpu/serve.py`).

`MicroBatcher` gathers single-image requests into micro-batches padded to
a power-of-two bucket (copies of the first row) and decodes them on one
thread; `make_http_server` is the stdlib HTTP front end (`POST /caption`,
`POST /pivot`, `GET /stats`, `GET /healthz`). Both are copies of the JAX
module's. Each micro-batch is uploaded to the models' device and decoded
under `torch.inference_mode()` on the batcher's thread. On a card the fc
and att features are rounded to bf16 on the host before the upload, as the
JAX services do on a TPU (ROADMAP A15); on the CPU they stay f32.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, List, Optional

import numpy as np
import torch

from .data.dataloader import to_bfloat16
from .models.base import Features
from .pivot import pivot_translate, post_edit
from .utils.text import decode_sequence

__all__ = ["CaptionService", "MicroBatcher", "PivotService",
           "make_http_server"]


class MicroBatcher:
    def __init__(self, decode_batch: Callable[[dict], List[str]],
                 *, max_batch: int = 32, max_wait_ms: float = 5.0):
        self.decode_batch = decode_batch
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1000.0
        self.q: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self.stats = {"requests": 0, "batches": 0, "batch_fill": 0.0}
        self.thread = threading.Thread(target=self._loop, daemon=True)
        self.thread.start()

    def submit(self, example: dict) -> Future:
        fut: Future = Future()
        self.q.put((example, fut))
        return fut

    def _loop(self):
        while not self._stop.is_set():
            try:
                first = self.q.get(timeout=0.2)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.perf_counter() + self.max_wait
            while len(batch) < self.max_batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    batch.append(self.q.get(timeout=remaining))
                except queue.Empty:
                    break
            examples = [b[0] for b in batch]
            futs = [b[1] for b in batch]
            n = len(examples)
            # pad to the next power-of-two BUCKET with copies of row 0:
            # static shapes per bucket keep a bounded set of warm
            # executables (log2(max_batch) of them) while a lone request
            # uploads 1 row of features, not max_batch rows — feature
            # upload is the dominant cost of a serving dispatch
            bucket = 1
            while bucket < n:
                bucket *= 2
            bucket = min(bucket, self.max_batch)
            while len(examples) < bucket:
                examples.append(examples[0])
            stacked = {k: np.stack([e[k] for e in examples])
                       for k in examples[0]}
            try:
                outs = self.decode_batch(stacked)
                for f, o in zip(futs, outs[:n]):
                    f.set_result(o)
            except Exception as e:  # propagate to all waiters
                for f in futs:
                    f.set_exception(e)
            self.stats["requests"] += n
            self.stats["batches"] += 1
            self.stats["batch_fill"] = (
                self.stats["requests"] / (self.stats["batches"] * self.max_batch))

    def close(self):
        self._stop.set()
        self.thread.join(timeout=2)


def _features(stacked: dict, device: torch.device) -> Features:
    def up(a, feature=False):
        t = torch.as_tensor(np.asarray(a, np.float32))
        if feature and device.type == "cuda":
            t = to_bfloat16(t)           # on the host, as ml_dtypes rounds
        return t.to(device)

    return Features(fc_feats=up(stacked["fc"], True),
                    att_feats=up(stacked["att"], True),
                    att_masks=up(stacked["masks"]))


def _submit(batcher: MicroBatcher, fc, att, masks, timeout: float):
    if masks is None:
        masks = np.ones(np.shape(att)[:1], np.float32)
    fut = batcher.submit({"fc": np.asarray(fc, np.float32),
                          "att": np.asarray(att, np.float32),
                          "masks": np.asarray(masks, np.float32)})
    return fut.result(timeout=timeout)


class CaptionService:
    """Feature-in, caption-out service around the beam decode, or the
    greedy decode (`model.sample`) with `greedy=True` or `beam_size=1`."""

    def __init__(self, model, vocab_ix_to_word: dict, *, beam_size: int = 3,
                 max_batch: int = 32, max_wait_ms: float = 5.0,
                 greedy: bool = False):
        self.model = model
        self.vocab = vocab_ix_to_word
        device = model.device
        greedy = greedy or beam_size == 1

        def decode_batch(stacked: dict) -> List[str]:
            with torch.inference_mode():
                feats = _features(stacked, device)
                if greedy:
                    seq = model.sample(feats)[0]
                else:
                    seq = model.sample_beam(feats,
                                            beam_size=beam_size).seq[:, 0]
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
    expansion on the way out. With `src2tgt` (Dict.align) a copy-attention
    NMT decodes over the extended vocab and its exact copies replace UNK."""

    def __init__(self, cap_model, nmt_model, zh_vocab: dict,
                 nmt_tgt_itos: dict, cap2nmt, *, cap_beam: int = 5,
                 nmt_beam: int = 15, nmt_max_len: int = 20,
                 max_batch: int = 32, max_wait_ms: float = 5.0,
                 replace_unk: bool = True, src2tgt=None):
        device = cap_model.device
        cap2nmt_t = torch.as_tensor(np.asarray(cap2nmt), dtype=torch.int64,
                                    device=device)
        s2t = (None if src2tgt is None else torch.as_tensor(
            np.asarray(src2tgt), dtype=torch.int64, device=device))

        def decode_batch(stacked: dict) -> List[dict]:
            with torch.inference_mode():
                feats = _features(stacked, device)
                zh, en, attn = pivot_translate(
                    cap_model, nmt_model, feats, cap2nmt_t,
                    cap_beam=cap_beam, nmt_beam=nmt_beam,
                    nmt_max_len=nmt_max_len, src2tgt=s2t)
                zh_np, en_np = zh.cpu().numpy(), en.cpu().numpy()
                attn_np = attn.cpu().numpy()
            zh_caps, en_caps = post_edit(zh_np, en_np, attn_np, zh_vocab,
                                         nmt_tgt_itos,
                                         replace_unk=replace_unk)
            return [{"zh": z, "en": e} for z, e in zip(zh_caps, en_caps)]

        self._decode_batch = decode_batch
        self.batcher = MicroBatcher(decode_batch, max_batch=max_batch,
                                    max_wait_ms=max_wait_ms)

    def pivot(self, fc: np.ndarray, att: np.ndarray,
              masks: Optional[np.ndarray] = None,
              timeout: float = 60.0) -> dict:
        return _submit(self.batcher, fc, att, masks, timeout)

    def close(self):
        self.batcher.close()


def make_http_server(service: "CaptionService", port: int = 8000,
                     pivot_service: Optional["PivotService"] = None
                     ) -> ThreadingHTTPServer:
    """POST /caption {"fc": [...], "att": [[...]]} -> {"caption": str};
    POST /pivot (same body) -> {"zh": str, "en": str} (when a
    PivotService is attached); GET /stats -> batcher stats."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/stats":
                self._send(200, service.batcher.stats)
            elif self.path == "/healthz":
                self._send(200, {"ok": True})
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            if self.path == "/caption":
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n))
                    cap = service.caption(np.asarray(req["fc"], np.float32),
                                          np.asarray(req["att"], np.float32))
                    self._send(200, {"caption": cap})
                except Exception as e:
                    self._send(400, {"error": str(e)})
            elif self.path == "/pivot" and pivot_service is not None:
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n))
                    out = pivot_service.pivot(
                        np.asarray(req["fc"], np.float32),
                        np.asarray(req["att"], np.float32))
                    self._send(200, out)
                except Exception as e:
                    self._send(400, {"error": str(e)})
            else:
                self._send(404, {"error": "not found"})

    return ThreadingHTTPServer(("127.0.0.1", port), Handler)
