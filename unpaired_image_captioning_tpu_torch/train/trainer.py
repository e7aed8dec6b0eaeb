"""Trainer: the captioner's XE training step (counterpart of
`unpaired_image_captioning_tpu/train/trainer.py`).

One `train(batch)` step, as the JAX `Trainer.train` runs its XE branch:
the captioner's teacher-forcing forward in training mode (dropout, and the
scheduled-sampling coins and draws once the schedule leaves 0, from the
trainer's `torch.Generator` on the device), `language_model_loss` over
labels[:, 1:], one backward over the summed loss, then the i2t transform
(`train/optimizer.py`: clip, method, weight decay) and `p -= lr * u`. The
learning rate, the scheduled-sampling probability and the epoch counters
live on the host. A run of `max_nan_steps` non-finite losses in a row
raises.

Not ported yet, each raising `NotImplementedError`: SCST (`sc_flag`,
ROADMAP A8), the NMT branch and the joint losses (`nmt_train_flag`, A7),
checkpoints and eval (`save` / `load` / `eval`, A9) and `use_bn` (A10,
raised by the model).
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

from .. import models as model_zoo
from ..losses.criterion import language_model_loss
from ..models.base import Features, resolve_device
from ..models.nmt_transformer import make_nmt_model
from ..models.transformer import TransformerModel
from .optimizer import DualOptim

_BATCH_KEYS = ("fc_feats", "att_feats", "attri_feats", "att_masks", "labels",
               "masks")


class Trainer:
    def __init__(self, cfg, *, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        init = torch.Generator().manual_seed(cfg.seed)
        self.i2t_model = (model_zoo.setup(cfg, device=self.device)
                          .init_params(init) if cfg.vocab_size else None)
        self.nmt_model = (make_nmt_model(cfg, device=self.device)
                          .init_params(init)
                          if getattr(cfg, "nmt_src_vocab_size", 0) else None)
        # the dropout stream of the training steps, on the device
        self.generator = torch.Generator(device=self.device).manual_seed(
            cfg.seed)
        self.optim = DualOptim(
            cfg, self._params(self.i2t_model), self._params(self.nmt_model))
        self.iteration = 0
        self.epoch = 0
        self.epoch_nmt = 0
        self.best_cider = None
        self.best_nmt_acc = None
        # consecutive non-finite losses; past the threshold train() raises
        self.nan_steps = 0
        self.max_nan_steps = 3

    @staticmethod
    def _params(model):
        return dict(model.named_parameters()) if model is not None else None

    def _batch(self, data: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        out = {}
        for k in _BATCH_KEYS:
            if data.get(k) is None:
                continue
            v = torch.as_tensor(np.asarray(data[k]))
            if v.is_floating_point():
                v = v.to(torch.float32)
            out[k] = v.to(self.device, non_blocking=True)
        return out

    def train(self, data: Dict[str, Any], *, sc_flag: bool = False
              ) -> Dict[str, float]:
        """One training step on a host batch dict (fc_feats, att_feats,
        att_masks, labels [B, L] with the leading BOS column, masks [B, L]).
        Returns host-side metric floats."""
        cfg = self.cfg
        if sc_flag:
            raise NotImplementedError("SCST training is not ported yet "
                                      "(ROADMAP A8)")
        if cfg.nmt_train_flag:
            raise NotImplementedError("NMT and joint training are not ported "
                                      "yet (ROADMAP A7)")
        lr_i2t = float(self.optim.i2t_lr(self.epoch))
        lr_nmt = float(self.optim.nmt_lr(self.epoch_nmt))
        ss_prob = float(self.optim.ss_prob(self.epoch))
        metrics: Dict[str, torch.Tensor] = {}
        total = None
        if self.i2t_model is not None and cfg.i2t_train_flag:
            batch = self._batch(data)
            feats = Features(fc_feats=batch["fc_feats"],
                             att_feats=batch.get("att_feats"),
                             attri_feats=batch.get("attri_feats"),
                             att_masks=batch.get("att_masks"))
            params = self._params(self.i2t_model)
            for p in params.values():
                p.grad = None
            # the transformer takes no scheduled sampling, as in JAX
            ss = ({} if isinstance(self.i2t_model, TransformerModel)
                  else {"ss_prob": ss_prob})
            out = self.i2t_model.forward(feats, batch["labels"],
                                         training=True,
                                         generator=self.generator, **ss)
            i2t_l = language_model_loss(out, batch["labels"][:, 1:],
                                        batch["masks"][:, 1:])
            metrics["i2t_loss"] = i2t_l
            total = i2t_l
        if total is not None:
            total.backward()
            with torch.no_grad():
                grads = {k: (p.grad if p.grad is not None
                             else torch.zeros_like(p))
                         for k, p in params.items()}
                upd, self.optim.i2t_state = self.optim.i2t_tx.update(
                    grads, self.optim.i2t_state, params)
                keys = list(params)
                torch._foreach_add_([params[k] for k in keys],
                                    [upd[k] for k in keys], alpha=-lr_i2t)
                for p in params.values():
                    p.grad = None
            metrics["total_loss"] = total
        self.optim.nmt_step += 1
        self.iteration += 1
        out = {k: float(v.detach()) for k, v in metrics.items()}
        out.setdefault("total_loss", 0.0)
        out.update(lr_i2t=lr_i2t, lr_nmt=lr_nmt, ss_prob=ss_prob)
        if not math.isfinite(out["total_loss"]):
            self.nan_steps += 1
            if self.nan_steps >= self.max_nan_steps:
                raise FloatingPointError(
                    f"non-finite loss for {self.nan_steps} consecutive steps "
                    f"at iter {self.iteration}: {out}")
        else:
            self.nan_steps = 0
        return out

    def eval(self, *args, **kwargs):
        raise NotImplementedError("eval is not ported yet (ROADMAP A9)")

    def save(self, *args, **kwargs):
        raise NotImplementedError("checkpoints are not ported yet "
                                  "(ROADMAP A9)")

    def load(self, *args, **kwargs):
        raise NotImplementedError("checkpoints are not ported yet "
                                  "(ROADMAP A9)")
