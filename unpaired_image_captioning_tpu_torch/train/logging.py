"""Metric logging (counterpart of
`unpaired_image_captioning_tpu/train/logging.py`).

Parity: reference `train.py:44,72-102` raw-TF summary writer with graceful
no-op when TF is absent. Here: an append-only `events.jsonl` (always) plus
TensorBoard summaries when tensorflow happens to be importable."""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricLogger:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "events.jsonl")
        self._tf_writer = None
        try:  # optional TF summaries (reference parity: no-op without TF)
            import tensorflow as tf  # type: ignore

            self._tf_writer = tf.summary.create_file_writer(log_dir)
        except ImportError:
            self._tf_writer = None

    def add_scalars(self, step: int, scalars: Dict[str, float]) -> None:
        rec = {"step": step, "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self._tf_writer is not None:
            import tensorflow as tf  # type: ignore

            with self._tf_writer.as_default():
                for k, v in scalars.items():
                    tf.summary.scalar(k, float(v), step=step)
            self._tf_writer.flush()
