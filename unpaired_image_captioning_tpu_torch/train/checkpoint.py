"""Checkpoint / resume (counterpart of
`unpaired_image_captioning_tpu/train/checkpoint.py`).

Parity: reference `train.py:90-128` / `trainer.py:98-104` — per-cadence
saves of `model_{i2t,nmt}[-best]`, optimizer states, an `infos` sidecar
(iter, epoch counters, loader iterator positions, best score, full config)
and `histories` (metric curves); `-best` dual-track by val CIDEr / NMT
acc; `--start_from` resume restores everything including mid-epoch
data-iterator positions (train.py:49-51, dataloader.py:371-377).

Format: the port's own. `torch.save` of each state dict (the models'
named parameters, `DualOptim.state_dict()`) as `model_i2t[-best].pt`,
`model_nmt[-best].pt` and `optimizer[-best].pt`, read back with
`torch.load(..., weights_only=True)`, beside the JSON sidecars of the JAX
package (`infos[-best].json`, `histories[-best].json`). The JAX package's
flax msgpack files are not read: converting them needs flax. Every file is
written to a temporary name and renamed into place, so a crash never
leaves a half-written checkpoint under the final name.
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional

import torch


def _replace_into(path: str, write) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    write(tmp)
    os.replace(tmp, path)


def save_state(path: str, state: Any) -> None:
    _replace_into(path, lambda tmp: torch.save(state, tmp))


def load_state(path: str, device=None) -> Any:
    return torch.load(path, map_location=device, weights_only=True)


def save_json(path: str, obj: Any) -> None:
    def write(tmp):
        with open(tmp, "w") as f:
            json.dump(obj, f)

    _replace_into(path, write)


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


class CheckpointManager:
    def __init__(self, checkpoint_path: str):
        self.dir = checkpoint_path   # made by the first save

    def _p(self, name: str, best: bool) -> str:
        return os.path.join(self.dir, name + ("-best" if best else ""))

    def path(self, name: str, best: bool = False) -> str:
        """The file of state `name` (model_i2t, model_nmt, optimizer)."""
        return self._p(name, best) + ".pt"

    def save(self, *, i2t_state=None, nmt_state=None, optim_state=None,
             infos: Optional[dict] = None, histories: Optional[dict] = None,
             best: bool = False) -> None:
        os.makedirs(self.dir, exist_ok=True)
        for name, state in (("model_i2t", i2t_state),
                            ("model_nmt", nmt_state),
                            ("optimizer", optim_state)):
            if state is not None:
                save_state(self.path(name, best), state)
        if infos is not None:
            save_json(self._p("infos", best) + ".json", infos)
        if histories is not None:
            save_json(self._p("histories", best) + ".json", histories)

    def load_params(self, name: str, best: bool = False, device=None):
        return load_state(self.path(name, best), device)

    def load_infos(self, best: bool = False) -> dict:
        return load_json(self._p("infos", best) + ".json")

    def load_histories(self, best: bool = False) -> dict:
        p = self._p("histories", best) + ".json"
        return load_json(p) if os.path.exists(p) else {}

    def has_checkpoint(self, best: bool = False) -> bool:
        return os.path.exists(self._p("infos", best) + ".json")


def check_resume_compat(saved_cfg: dict, cfg) -> None:
    """Parity: train.py:30-35 asserts on rnn_type/rnn_size/num_layers."""
    for k in ("caption_model", "rnn_type", "rnn_size", "num_layers",
              "input_encoding_size"):
        if k in saved_cfg and getattr(cfg, k) != saved_cfg[k]:
            raise ValueError(
                f"resume mismatch on {k!r}: checkpoint={saved_cfg[k]!r} "
                f"config={getattr(cfg, k)!r}")
