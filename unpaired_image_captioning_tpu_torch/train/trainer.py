"""Trainer: the joint training step of the captioner and the NMT
(counterpart of `unpaired_image_captioning_tpu/train/trainer.py`).

One `train(batch)` step, as the JAX `Trainer.train` runs it, sums into
one total and takes one backward over it:

- the captioner's XE loss: its teacher-forcing forward in training mode
  (dropout, and the scheduled-sampling coins and draws once the schedule
  leaves 0), `language_model_loss` over labels[:, 1:];
- or, with `sc_flag`, its SCST loss (`_rl_loss`): a multinomial sample
  drawn from the trainer's generator and a greedy baseline, both decoded
  without gradients; rewards against `batch["gts"]` / `["gts_masks"]`
  from `ops/cider.py` over the trainer's `df_table`, on the device; the
  sampled tokens' logprobs recomputed by a teacher-forcing forward without
  dropout (`training=False`), with gradients, and `reward_loss`;
- with `nmt_train_flag`, the NMT loss on `batch["nmt"]` = {src, tgt,
  lengths}: the NMT's teacher-forcing forward in training mode and
  `nmt_loss` with `cfg.label_smoothing`, with ppl / accuracy / word
  statistics;
- Weight_Trans, when the trainer holds `joint_vocab` = (captioner rows, NMT
  source rows) and a captioner: the MSE between the captioner's word
  embedding and the NMT's source embedding on those rows;
- KLD against the frozen teacher `nmt_teacher` (a state dict of the NMT's
  parameters) when `nmt_kld_train_flag` is set;
- Weight_Trans_y, when the trainer holds `joint_vocab_y` = (a frozen
  English table [V, D], its rows, NMT target rows): the MSE between the
  NMT's target embedding and that table, which gets no gradient.

Then each model's transform (`train/optimizer.py`: clip, method, weight
decay) and `p -= lr * u`: the captioner's at `i2t_lr(epoch)`, the NMT's
(`DualOptim.nmt_tx`, clipped at `nmt_max_grad_norm`) at
`nmt_lr(epoch_nmt)`. A parameter without a gradient takes zeros, as JAX's
autodiff gives an unused parameter. Dropout and the sampling draws come
from the trainer's `torch.Generator` on the device; learning rates, the
scheduled-sampling probability and the epoch counters live on the host. A
run of `max_nan_steps` non-finite losses in a row raises.

`eval` runs `eval/eval_utils.py::eval_split` on the val split and keeps
the best CIDEr (or -loss without language_eval) and the best NMT valid
accuracy. `save` / `load` write and restore a checkpoint through
`train/checkpoint.py` (the models' state dicts, `DualOptim.state_dict()`,
and the infos sidecar with the counters, the best scores, the config, the
loader state and the generator's state), so a resumed run draws the same
dropout masks and SCST samples as an uninterrupted one. Pretrained NMT
word vectors (`pre_word_vecs_enc` / `_dec`, `.npy` or `.npz` with
`embedding`) overwrite the BiLSTM NMT's word tables at construction.
`profile` runs training steps under `torch.profiler` and writes a Chrome
trace (JAX writes a TensorBoard trace).

With `use_bn`, the XE forward collects the batch moments of its BatchNorms
and the step blends them into the running statistics after the
captioner's update (`models/att.py::apply_bn_updates`), as the JAX step
does; the running `mean` / `var` are parameters there too (see the
model's doc). StackCap's forward returns three heads: the XE loss sums
them, and the SCST recompute reads the last.
"""

from __future__ import annotations

import copy
import math
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from .. import models as model_zoo
from ..losses.criterion import (kld_loss, language_model_loss, nmt_loss,
                                reward_loss, weight_trans_loss)
from ..losses.rewards import get_self_critical_reward
from ..models.att import apply_bn_updates
from ..models.base import Features, resolve_device
from ..models.nmt_transformer import TransformerNMTModel, make_nmt_model
from ..models.transformer import TransformerModel
from ..ops.cider import DfTable, empty_df_table
from .checkpoint import CheckpointManager, check_resume_compat, save_json
from .optimizer import DualOptim

_BATCH_KEYS = ("fc_feats", "att_feats", "attri_feats", "att_masks", "labels",
               "masks", "gts", "gts_masks")
_NMT_KEYS = ("src", "tgt", "lengths")


class Trainer:
    def __init__(self, cfg, *, device="cuda", joint_vocab=None,
                 joint_vocab_y=None,
                 nmt_teacher: Optional[Dict[str, Any]] = None,
                 df_table: Optional[DfTable] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        # the SCST rewards' df table (scripts/prepro_ngrams.load_df_table)
        self.df_table = (df_table if df_table is not None
                         else empty_df_table(self.device))
        init = torch.Generator().manual_seed(cfg.seed)
        self.i2t_model = (model_zoo.setup(cfg, device=self.device)
                          .init_params(init) if cfg.vocab_size else None)
        self.nmt_model = (make_nmt_model(cfg, device=self.device)
                          .init_params(init)
                          if getattr(cfg, "nmt_src_vocab_size", 0) else None)
        if self.nmt_model is not None and (
                getattr(cfg, "pre_word_vecs_enc", "")
                or getattr(cfg, "pre_word_vecs_dec", "")):
            # fork train.py:442-443 load_pretrained_vectors (the fork only
            # wires this for the RNN route's Embeddings)
            if not hasattr(self.nmt_model, "load_pretrained_embeddings"):
                raise ValueError("pre_word_vecs_* applies to the BiLSTM NMT "
                                 "route")
            self.nmt_model.load_pretrained_embeddings(
                enc_path=cfg.pre_word_vecs_enc, dec_path=cfg.pre_word_vecs_dec)
        # the frozen KLD teacher: the NMT with the teacher's parameters
        self.nmt_teacher = None
        if nmt_teacher is not None:
            self.nmt_teacher = copy.deepcopy(self.nmt_model)
            self.nmt_teacher.load_state_dict(nmt_teacher)
            self.nmt_teacher.requires_grad_(False)

        def rows(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.long,
                                   device=self.device)

        # joint-vocabulary rows of Weight_Trans: (captioner, NMT source)
        self.joint_vocab = (tuple(rows(a) for a in joint_vocab)
                            if joint_vocab is not None else None)
        # Weight_Trans_y: (frozen table, its rows, NMT target rows)
        self.joint_vocab_y = None
        if joint_vocab_y is not None:
            table, table_rows, tgt_rows = joint_vocab_y
            self.joint_vocab_y = (
                torch.as_tensor(np.asarray(table), dtype=torch.float32,
                                device=self.device),
                rows(table_rows), rows(tgt_rows))
        # the dropout stream of the training steps, on the device
        self.generator = torch.Generator(device=self.device).manual_seed(
            cfg.seed)
        self.optim = DualOptim(
            cfg, self._params(self.i2t_model), self._params(self.nmt_model))
        self.ckpt = CheckpointManager(cfg.checkpoint_path)
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

    def _batch(self, data: Dict[str, Any], keys=_BATCH_KEYS
               ) -> Dict[str, torch.Tensor]:
        out = {}
        for k in keys:
            if data.get(k) is None:
                continue
            v = torch.as_tensor(np.asarray(data[k]))
            if v.is_floating_point():
                v = v.to(torch.float32)
            elif v.dtype != torch.bool:
                v = v.to(torch.int64)       # ids: labels, gts, NMT batches
            out[k] = v.to(self.device, non_blocking=True)
        return out

    def _update(self, params, tx, state, lr: float):
        """One transform step of `params` from their .grad (zeros where
        there is none); returns the new transform state."""
        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for k, p in params.items()}
        upd, state = tx.update(grads, state, params)
        keys = list(params)
        torch._foreach_add_([params[k] for k in keys],
                            [upd[k] for k in keys], alpha=-lr)
        return state

    def _nmt_terms(self, data, metrics: Dict[str, torch.Tensor]):
        """The NMT loss and the losses coupled to it; returns their sum."""
        cfg = self.cfg
        if data["nmt"].get("src_feats") is not None:
            # the port's NMT models take no source-feature LUTs: training
            # on without them would drop the features silently
            raise NotImplementedError(
                "an NMT batch with src_feats: source word features are not "
                "ported yet (ROADMAP A11)")
        nb = self._batch(data["nmt"], _NMT_KEYS)
        src, lengths, tgt = nb["src"].long(), nb["lengths"].long(), \
            nb["tgt"].long()
        nmt = self.nmt_model
        outs, _ = nmt.forward(src, lengths, tgt, training=True,
                              generator=self.generator)
        logits = nmt.generator_logits(outs)
        nmt_l, stats = nmt_loss(logits, tgt[:, 1:],
                                label_smoothing=cfg.label_smoothing)
        metrics.update(nmt_loss=nmt_l, nmt_ppl=stats.ppl(),
                       nmt_acc=stats.accuracy(), nmt_words=stats.n_words)
        total = nmt_l
        if self.joint_vocab is not None and self.i2t_model is not None:
            cap_rows, src_rows = self.joint_vocab
            wemb = weight_trans_loss(self.i2t_model.embed,
                                     nmt.src_embedding(), cap_rows, src_rows)
            metrics["wemb_loss"] = wemb
            total = total + wemb
        if cfg.nmt_kld_train_flag and self.nmt_teacher is not None:
            with torch.no_grad():
                t_outs, _ = self.nmt_teacher.forward(src, lengths, tgt)
                t_probs = torch.softmax(
                    self.nmt_teacher.generator_logits(t_outs), dim=-1)
            kld = kld_loss(torch.log_softmax(logits, dim=-1), t_probs)
            metrics["nmt_kld"] = kld
            total = total + kld
        if self.joint_vocab_y is not None:
            table, table_rows, tgt_rows = self.joint_vocab_y
            wemb_y = weight_trans_loss(nmt.tgt_embedding(), table, tgt_rows,
                                       table_rows)
            metrics["wemb_y_loss"] = wemb_y
            total = total + wemb_y
        return total

    def _rl_loss(self, feats: Features, gen: torch.Tensor,
                 greedy: torch.Tensor, gts: torch.Tensor,
                 gts_masks: torch.Tensor):
        """The SCST loss of given sequences: gen [B, T] sampled and greedy
        [B, T] baseline ids, gts [B, R, Tg] int64 with gts_masks [B, R].
        The advantage reward(gen) - reward(greedy) carries no gradient; the
        sampled tokens' logprobs come from a teacher-forcing forward of
        [0, gen] without dropout, so the distribution differentiated is the
        one sampled from. Returns (the loss, the samples' rewards [B])."""
        cfg = self.cfg
        with torch.no_grad():
            adv, rs = get_self_critical_reward(
                gen, greedy, gts, gts_masks, self.df_table,
                cider_weight=cfg.cider_reward_weight,
                bleu_weight=cfg.bleu_reward_weight)
        seq_full = torch.cat([torch.zeros_like(gen[:, :1]), gen], 1)
        out = self.i2t_model.forward(feats, seq_full, training=False)
        if isinstance(out, list):
            out = out[-1]   # stackcap: the final head drives decoding
        logps = torch.gather(out, -1, gen[..., None])[..., 0]
        return reward_loss(logps, gen, adv), rs

    def train(self, data: Dict[str, Any], *, sc_flag: bool = False
              ) -> Dict[str, float]:
        """One training step on a host batch dict: fc_feats, att_feats,
        att_masks, labels [B, L] with the leading BOS column and masks
        [B, L] for the captioner (with `sc_flag`: gts [B, R, Tg] and
        gts_masks [B, R] in place of labels and masks); "nmt" = {src [B,
        S], tgt [B, T] (BOS ... EOS, PAD-padded), lengths [B]} for the NMT.
        Returns host floats."""
        cfg = self.cfg
        lr_i2t = float(self.optim.i2t_lr(self.epoch))
        lr_nmt = float(self.optim.nmt_lr(self.epoch_nmt))
        ss_prob = float(self.optim.ss_prob(self.epoch))
        metrics: Dict[str, torch.Tensor] = {}
        train_i2t = self.i2t_model is not None and cfg.i2t_train_flag
        train_nmt = self.nmt_model is not None and cfg.nmt_train_flag
        i2t_params = self._params(self.i2t_model)
        nmt_params = self._params(self.nmt_model)
        for params in (i2t_params, nmt_params):
            for p in (params or {}).values():
                p.grad = None
        terms = []
        # use_bn: the XE forward collects the batch moments here, and they
        # are blended into the running statistics after the update
        bn_aux = None
        if train_i2t:
            batch = self._batch(data)
            feats = Features(fc_feats=batch["fc_feats"],
                             att_feats=batch.get("att_feats"),
                             attri_feats=batch.get("attri_feats"),
                             att_masks=batch.get("att_masks"))
            if sc_flag:
                if "gts" not in batch or "gts_masks" not in batch:
                    raise ValueError("SCST scores the samples against "
                                     "batch['gts'] and batch['gts_masks']")
                # both decodes run without gradients (`sample`)
                gen, _ = self.i2t_model.sample(feats, greedy=False,
                                               generator=self.generator)
                greedy, _ = self.i2t_model.sample(feats, greedy=True)
                i2t_l, rewards = self._rl_loss(feats, gen, greedy,
                                               batch["gts"],
                                               batch["gts_masks"])
                metrics["avg_reward"] = rewards.mean()
            else:
                # the transformer takes no scheduled sampling, as in JAX
                ss = ({} if isinstance(self.i2t_model, TransformerModel)
                      else {"ss_prob": ss_prob})
                if hasattr(self.i2t_model, "bn0"):
                    bn_aux = ss["aux_out"] = {}
                out = self.i2t_model.forward(feats, batch["labels"],
                                             training=True,
                                             generator=self.generator, **ss)
                i2t_l = language_model_loss(out, batch["labels"][:, 1:],
                                            batch["masks"][:, 1:])
            metrics["i2t_loss"] = i2t_l
            terms.append(i2t_l)
        if train_nmt:
            terms.append(self._nmt_terms(data, metrics))
        if terms:
            total = sum(terms[1:], terms[0])
            total.backward()
            with torch.no_grad():
                if train_i2t:
                    self.optim.i2t_state = self._update(
                        i2t_params, self.optim.i2t_tx, self.optim.i2t_state,
                        lr_i2t)
                    if bn_aux:
                        apply_bn_updates(self.i2t_model, bn_aux)
                if train_nmt:
                    self.optim.nmt_state = self._update(
                        nmt_params, self.optim.nmt_tx, self.optim.nmt_state,
                        lr_nmt)
            for params in (i2t_params, nmt_params):
                for p in (params or {}).values():
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

    def eval(self, loader, *, nmt_valid=None, num_images: int = -1,
             beam_size: Optional[int] = None, language_eval_refs=None
             ) -> dict:
        """Validation pass with best-CIDEr / best-NMT-acc tracking
        (parity: trainer.py:195-215). Returns the eval_split dict plus
        {'is_best': bool}."""
        from ..eval.eval_utils import eval_split

        out = eval_split(self.i2t_model, loader, split="val",
                         num_images=num_images,
                         beam_size=beam_size or self.cfg.beam_size,
                         language_eval_refs=language_eval_refs,
                         model_id=self.cfg.id, nmt_model=self.nmt_model,
                         nmt_valid=nmt_valid)
        score = (out.get("lang_stats") or {}).get("CIDEr", -out["loss"])
        out["is_best"] = self.best_cider is None or score > self.best_cider
        if out["is_best"]:
            self.best_cider = score
        if out.get("nmt_stats"):
            acc = out["nmt_stats"]["valid_acc"]
            if self.best_nmt_acc is None or acc > self.best_nmt_acc:
                self.best_nmt_acc = acc
        return out

    def infos(self, loader_state: Optional[dict] = None, **extra) -> dict:
        """The infos sidecar of a checkpoint: the counters, the best
        scores, the config, the loader state and the generator's state
        (the JAX package's `rng`)."""
        return {"iter": self.iteration, "epoch": self.epoch,
                "epoch_nmt": self.epoch_nmt, "best_cider": self.best_cider,
                "best_nmt_acc": self.best_nmt_acc,
                "opt": self.cfg.to_dict(), "loader_state": loader_state,
                "generator": self.generator.get_state().tolist(), **extra}

    def profile(self, data_iter, n_steps: int = 5, log_dir: str = None,
                sc_flag: bool = False) -> dict:
        """`n_steps` training steps (`train`, batches from `data_iter`)
        under `torch.profiler`, recording host activity, and the card's
        when the trainer is on one; writes the Chrome trace `trace.json`
        (viewable in Perfetto) under `log_dir`, by default
        `checkpoint_path/trace`. Each step is timed from a synchronized
        card to a synchronized card, so its device work is in its time.
        Returns the trace dir, the step count and the mean and least step
        wall in seconds."""
        import time

        from torch.profiler import ProfilerActivity, profile

        log_dir = log_dir or os.path.join(self.cfg.checkpoint_path, "trace")
        os.makedirs(log_dir, exist_ok=True)
        on_card = self.device.type == "cuda"
        activities = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if on_card else [])

        def sync():
            if on_card:
                torch.cuda.synchronize(self.device)

        times = []
        with profile(activities=activities) as prof:
            for _ in range(n_steps):
                sync()
                t0 = time.perf_counter()
                self.train(next(data_iter), sc_flag=sc_flag)
                sync()
                times.append(time.perf_counter() - t0)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
        return {"trace_dir": log_dir, "steps": n_steps,
                "mean_step_s": sum(times) / len(times),
                "min_step_s": min(times)}

    def save(self, loader_state: Optional[dict] = None,
             histories: Optional[dict] = None, best: bool = False) -> None:
        """Write a checkpoint (the `-best` track with `best`), and the NMT's
        `nmt_config.json`: `model_type` ("rnn" or "transformer") and the
        model's constructor arguments, so `NMTModel(**rest)` or
        `TransformerNMTModel(**rest)` rebuilds it."""
        self.ckpt.save(
            i2t_state=(self.i2t_model.state_dict()
                       if self.i2t_model is not None else None),
            nmt_state=(self.nmt_model.state_dict()
                       if self.nmt_model is not None else None),
            optim_state=self.optim.state_dict(),
            infos=self.infos(loader_state), histories=histories, best=best)
        if self.nmt_model is not None:
            kind = ("transformer" if isinstance(self.nmt_model,
                                                TransformerNMTModel)
                    else "rnn")
            save_json(os.path.join(self.ckpt.dir, "nmt_config.json"),
                      {"model_type": kind, **self.nmt_model.init_args})

    def load(self, best: bool = False) -> dict:
        """Restore a checkpoint of `cfg.checkpoint_path` onto the trainer's
        device: parameters, optimizer state, counters, best scores and the
        generator. Returns the infos (with the loader state)."""
        infos = self.ckpt.load_infos(best=best)
        check_resume_compat(infos.get("opt", {}), self.cfg)
        for name, model in (("model_i2t", self.i2t_model),
                            ("model_nmt", self.nmt_model)):
            if model is not None:
                model.load_state_dict(self.ckpt.load_params(
                    name, best=best, device=self.device))
        self.optim.load_state_dict(
            self.ckpt.load_params("optimizer", best=best,
                                  device=self.device), device=self.device)
        self.iteration = infos["iter"]
        self.epoch = infos["epoch"]
        self.epoch_nmt = infos["epoch_nmt"]
        self.best_cider = infos.get("best_cider")
        self.best_nmt_acc = infos.get("best_nmt_acc")
        if infos.get("generator") is not None:
            self.generator.set_state(torch.tensor(infos["generator"],
                                                  dtype=torch.uint8))
        return infos
