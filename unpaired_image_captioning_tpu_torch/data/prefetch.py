"""Background batch prefetchers (counterpart of
`unpaired_image_captioning_tpu/data/prefetch.py`).

Parity role: reference `BlobFetcher` (dataloader.py:338-408), a torch
DataLoader with 4 worker processes and a resume-aware SubsetSampler.

- `ThreadPrefetcher`: a bounded-queue thread running the whole get_batch;
  it overlaps host IO with device compute when batch assembly is cheaper
  than a step.
- `ProcessPrefetcher`: the BlobFetcher equivalent. The loader's plan phase
  (every draw of the loader's state: indices, captions, the NMT batch)
  stays in the parent, so the batch stream is bit-identical to
  synchronous `get_batch` and resume is exact: `state_dict()` returns the
  loader state snapshotted before the next batch the consumer will
  receive was planned. Only the feature assembly (file reads and padding,
  which draw nothing from the loader's state) fans out over worker
  processes, one row an image (`gather_features`); the parent repeats
  the rows for each image's captions (`replicate`), so the seq_per_img
  copies never cross a process boundary, and results re-order by sequence
  number. `rewind()` hands the loader back before another reader (the
  eval pass) draws from it, so the stream stays that of synchronous reads
  with the evals in between; the batches planned past that point are
  dropped, and the workers skip the tasks of theirs still queued (a
  shared counter: the sequence number below which a task is stale), so
  at most one batch a worker is assembled in vain after a rewind.

Workers start from a `forkserver` context, not `fork`. The training CLI
builds its prefetcher after the trainer, whose models already live on the
card, and `chip_smoke.py` runs the CLI in a process that has used the card
for minutes: forking such a process copies a live CUDA context and
whatever locks the CUDA runtime's and the intra-op pool's threads hold at that
moment, a deadlock class. The fork server is a fresh interpreter that
never imports torch; each worker forks from it and receives the loader's
`FeatureReader` by pickle (its image list and feature settings, no HDF5
handles: `reopen` opens them in the worker). Workers never touch
`torch.cuda`, and
what they send back is numpy only (bf16 features, `feat_dtype="bfloat16"`,
as their 16-bit patterns, viewed as bf16 again by the parent): arrays of
at least `_SHM_MIN_BYTES` travel through POSIX shared memory, the rest
through the result queue.
The parent's replication copies out of the shared memory, which it
unlinks at once: the batches `get()` returns own their arrays.
"""

from __future__ import annotations

import collections
import multiprocessing as mp
import queue
import threading
from typing import Callable

import numpy as np
import torch


class ThreadPrefetcher:
    def __init__(self, fetch_fn: Callable[[], dict], depth: int = 4):
        self.fetch_fn = fetch_fn
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._worker, daemon=True)
        self.thread.start()

    def _worker(self):
        while not self._stop.is_set():
            try:
                item = self.fetch_fn()
            except Exception as e:  # surface worker errors to the consumer
                item = e
            while not self._stop.is_set():
                try:
                    self.q.put(item, timeout=0.5)
                    break
                except queue.Full:
                    continue

    def get(self) -> dict:
        item = self.q.get()
        if isinstance(item, Exception):
            raise item
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass


# arrays at least this large travel through POSIX shared memory instead of
# being pickled through the result queue: the att features alone are
# 80 MB a batch at the recipe's shapes, and a queue pickle is a full
# extra copy on each side
_SHM_MIN_BYTES = 1 << 20


def _feature_worker(reader, task_q, result_q, stale_below):
    # a forkserver child: fresh HDF5 handles, then feature reads only;
    # torch.cuda is never touched
    from multiprocessing import shared_memory

    reader.reopen()
    while True:
        item = task_q.get()
        if item is None:
            return
        seq, ixs = item
        if seq < stale_below.value:
            result_q.put((seq, None))    # dropped by rewind(): not read
            continue
        try:
            feats = reader.gather(ixs)
            out = {}
            for k, v in feats.items():
                dtype = None
                if isinstance(v, torch.Tensor):
                    # bf16 features (feat_dtype="bfloat16") travel as their
                    # 16-bit patterns: half the f32 bytes, as JAX's do
                    dtype, v = "bfloat16", v.view(torch.int16).numpy()
                if v is not None and v.nbytes >= _SHM_MIN_BYTES:
                    shm = shared_memory.SharedMemory(create=True,
                                                     size=v.nbytes)
                    np.ndarray(v.shape, v.dtype, buffer=shm.buf)[...] = v
                    out[k] = ("shm", shm.name, v.shape, dtype or v.dtype)
                    shm.close()
                else:
                    out[k] = ("raw", v, dtype)
            result_q.put((seq, out))
        except Exception as e:
            result_q.put((seq, e))


class ProcessPrefetcher:
    """Multi-process feature assembly behind a single-threaded plan stream.

    get() yields batches in exactly the order synchronous
    `loader.get_batch(split)` would produce them; `state_dict()` resumes
    from the batch after the last one consumed."""

    def __init__(self, loader, split: str, num_workers: int = 4,
                 depth: int = 8):
        self.loader = loader
        self.split = split
        self.depth = max(depth, num_workers + 1)
        # start the shared-memory resource tracker before the fork server:
        # the server and its children then share this one tracker instead
        # of racing to spawn their own at the first SharedMemory create
        from multiprocessing import shared_memory

        warm = shared_memory.SharedMemory(create=True, size=1)
        warm.close()
        warm.unlink()

        ctx = mp.get_context("forkserver")
        # SimpleQueue, not Queue: Queue's feeder thread orders wrong
        # against join at shutdown; SimpleQueue writes the pipe directly
        # under a shared lock. Payloads are small: big arrays go by shm.
        self._task_q = ctx.SimpleQueue()
        self._result_q = ctx.SimpleQueue()
        # tasks with a sequence number below this are stale (rewind())
        self._stale_below = ctx.Value("q", 0)
        self._workers = [
            ctx.Process(target=_feature_worker,
                        args=(loader.features, self._task_q,
                              self._result_q, self._stale_below),
                        daemon=True)
            for _ in range(num_workers)]
        for w in self._workers:
            w.start()
        self._next_plan_seq = 0          # next sequence number to plan
        self._results_received = 0       # results pulled off the queue
        self._plans = collections.OrderedDict()   # seq -> (state, plan)
        self._done = {}                  # seq -> assembled features
        self._stale = set()              # dropped by rewind(), in flight
        self.skipped = 0                 # of those, tasks no worker read
        self._fill()

    def _materialize(self, out: dict, rows=None) -> dict:
        """The worker's arrays, replicated for the captions (copies; the
        plan's `rows` of them, where given), with their shared memory
        unlinked."""
        from multiprocessing import shared_memory

        feats, shms = {}, []
        for k, v in out.items():
            if v[0] == "shm":
                _, name, shape, dtype = v
                shm = shared_memory.SharedMemory(name=name)
                bf16 = isinstance(dtype, str)
                a = np.ndarray(shape, np.int16 if bf16 else dtype,
                               buffer=shm.buf)
                feats[k] = (torch.from_numpy(a).view(torch.bfloat16) if bf16
                            else a)
                shms.append(shm)
            else:
                feats[k] = (v[1] if v[2] is None
                            else torch.from_numpy(v[1]).view(torch.bfloat16))
        feats = self.loader.replicate(feats, rows)
        for shm in shms:
            shm.close()
            shm.unlink()
        return feats

    def _fill(self):
        while len(self._plans) < self.depth:
            state = self.loader.state_dict()
            plan = self.loader.plan_batch(self.split)
            seq = self._next_plan_seq
            self._next_plan_seq += 1
            self._task_q.put((seq, plan["ixs"]))
            self._plans[seq] = (state, plan)

    def _recv(self, timeout: float = 120.0):
        """One result off the queue, with a liveness guard so that a worker
        that died (a segfault, an OOM kill, a failed start) raises within a
        second instead of hanging."""
        waited = 0.0
        while not self._result_q._reader.poll(1.0):
            waited += 1.0
            dead = [(w.pid, w.exitcode) for w in self._workers
                    if not w.is_alive()]
            if dead or waited >= timeout:
                raise RuntimeError(
                    f"feature workers unresponsive for {waited:.0f}s"
                    + (f" (dead: pid, exit code {dead})" if dead else ""))
        s, feats = self._result_q.get()
        self._results_received += 1
        if s in self._stale:
            self._stale.discard(s)
            if feats is None:
                self.skipped += 1
            elif isinstance(feats, dict):
                self._unlink(feats)
            return
        if isinstance(feats, Exception):
            raise feats
        self._done[s] = feats

    @staticmethod
    def _unlink(out: dict) -> None:
        from multiprocessing import shared_memory

        for v in out.values():
            if v[0] == "shm":
                shm = shared_memory.SharedMemory(name=v[1])
                shm.close()
                shm.unlink()

    def get(self) -> dict:
        """The next batch."""
        self._fill()
        seq = next(iter(self._plans))
        while seq not in self._done:
            self._recv()
        _, plan = self._plans.pop(seq)
        plan = dict(plan)
        plan.pop("ixs")
        feats = self._materialize(self._done.pop(seq), plan.pop("rows", None))
        plan.update(feats)
        self._fill()
        return plan

    def rewind(self) -> None:
        """Give the loader the state of the next unconsumed batch again and
        drop the batches planned past it. Call it before another reader
        draws from the loader (the eval pass of the training CLI: its
        captions and NMT batches come from the same generators): that
        reader then draws what it draws without workers, and the next
        get() plans again from the state it leaves. The workers skip the
        dropped batches they have not started."""
        if not self._plans:
            return
        state, _ = next(iter(self._plans.values()))
        self.loader.load_state_dict(state)
        self._stale_below.value = self._next_plan_seq
        for seq in self._plans:
            if seq in self._done:
                self._unlink(self._done.pop(seq))
            else:
                self._stale.add(seq)
        self._plans.clear()

    def state_dict(self) -> dict:
        """Loader state for the next batch the consumer will receive:
        loading it into a fresh loader and reading synchronously reproduces
        the stream from that point."""
        if self._plans:
            state, _ = next(iter(self._plans.values()))
            return state
        return self.loader.state_dict()

    def close(self):
        # drain the exact number of outstanding results first (a worker is
        # idle only after its task in flight completes), then send the
        # sentinels: sentinels first would race the puts in flight and
        # leak their segments
        outstanding = self._next_plan_seq - self._results_received
        try:
            for _ in range(outstanding):
                self._recv(timeout=30.0)
        except Exception:
            pass  # shutting down: a wedged worker is terminated below
        for _ in self._workers:
            self._task_q.put(None)
        for w in self._workers:
            w.join(timeout=5.0)
            if w.is_alive():
                w.terminate()
                w.join(timeout=5.0)
        # unlink the segments of results never handed out
        for out in self._done.values():
            self._unlink(out)
        self._done.clear()
