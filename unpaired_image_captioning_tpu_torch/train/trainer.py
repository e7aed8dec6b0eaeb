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

With `mesh` (a `parallel.make_mesh` mesh; one trainer a rank), the step
computes the one-device step on the global batch, as GSPMD does for the
JAX trainer. Each rank is handed its data rank's contiguous block of the
global batch (`parallel.shard_batch`: uneven blocks where the batch does
not divide; the loader gives its block so when built with the rank's
`data_rank`, and reads only that block's features). Every masked mean
divides its local sum by the global count (`parallel.mesh.data_parallel`:
the criteria, the `use_bn` batch moments, `avg_reward`), so the ranks'
losses add up to the global loss; the losses on parameters alone
(Weight_Trans / _y) count on data rank 0 only. The gradients are summed
over the data axis before the transform, so the global-norm clip reads
the whole gradient. SCST
decodes and scores each rank's rows, with the df table on every rank.
On a mesh whose "model" axis has more than one rank, the captioner's
leaves that `parallel.param_sharding` splits live as this rank's 1/M
shard between steps (`parallel.mesh.ModelShards`), with their optimizer
moments; they are gathered whole for the step's kernels, and the reduced
gradient is cut back to the shard (the clip reads the norm of the whole
gradient).
Dropout and sampling draw from a generator seeded with `seed` + the data
rank. Only global rank 0 writes checkpoints, with whole tensors in the
one-device format; `load` places a checkpoint from any mesh (or one
device) with this trainer's placements. `eval` decodes each data rank's
rows (`eval_split(mesh=...)`).

With `use_bn`, the XE forward collects the batch moments of its BatchNorms
and the step blends them into the running statistics after the
captioner's update (`models/att.py::apply_bn_updates`), as the JAX step
does; the running `mean` / `var` are parameters there too (see the
model's doc). StackCap's forward returns three heads: the XE loss sums
them, and the SCST recompute reads the last.

The compute dtype (`cfg.dtype`, ROADMAP A15), as the JAX trainer applies
it. With "bfloat16" the three feature keys of every batch are rounded to
bf16 on the host before the upload, on any device (JAX
`train/trainer.py:289-298`), so the models carry bf16 features and a bf16
LSTM state. On a card the step also computes with bf16 copies of the f32
master parameters (`_compute_params`, JAX's `_cast_compute` on a TPU): each
f32 parameter of both models is replaced by one `p.to(bfloat16)` for the
forward, the SCST sample and the backward, so the gradients reach the f32
masters through the cast; the optimizer state, the clip and the update stay
f32, and the `use_bn` moments (taken in f32) are blended into the f32
leaves. The transformer captioner and NMT take the same route: their
kernels (B4-B8) have bf16 entries.
"""

from __future__ import annotations

import contextlib
import copy
import math
import os
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import models as model_zoo
from ..losses.criterion import (kld_loss, language_model_loss, nmt_loss,
                                reward_loss, weight_trans_loss)
from ..data.dataloader import FEATURE_KEYS, to_bfloat16
from ..losses.rewards import get_self_critical_reward
from ..models.att import apply_bn_updates
from ..models.base import Features, resolve_device
from ..models.nmt_transformer import TransformerNMTModel, make_nmt_model
from ..models.transformer import TransformerModel
from ..ops.cider import DfTable, empty_df_table
from ..parallel.mesh import (ModelShards, all_reduce_, axis, broadcast_,
                             data_parallel, gather_objects, mean_share,
                             global_sum, param_sharding)
from .checkpoint import CheckpointManager, check_resume_compat, save_json
from .optimizer import DualOptim, global_sq_norm

_BATCH_KEYS = ("fc_feats", "att_feats", "attri_feats", "att_masks", "labels",
               "masks", "gts", "gts_masks")
_NMT_KEYS = ("src", "tgt", "lengths", "src_feats")
_DTYPES = ("float32", "bfloat16")


@contextlib.contextmanager
def bf16_params(*models):
    """Within the block every f32 parameter of `models` is one bf16 copy,
    `p.to(torch.bfloat16)` (JAX's `_cast_compute` of the tree): a tied
    parameter's copy serves every module that holds it, so its gradient
    sums in bf16 and reaches the master once, as a cast leaf's does in
    JAX. The copies are differentiable, so `.grad` lands on the f32
    masters; they are put back on leaving."""
    copies, swapped = {}, []
    for model in models:
        for mod in model.modules():
            for name, p in list(mod._parameters.items()):
                if p is None or p.dtype != torch.float32:
                    continue
                if id(p) not in copies:
                    copies[id(p)] = p.to(torch.bfloat16)
                swapped.append((mod, name, p))
                mod._parameters[name] = copies[id(p)]
    try:
        yield
    finally:
        for mod, name, p in swapped:
            mod._parameters[name] = p


class Trainer:
    def __init__(self, cfg, *, device="cuda", mesh=None, joint_vocab=None,
                 joint_vocab_y=None,
                 nmt_teacher: Optional[Dict[str, Any]] = None,
                 df_table: Optional[DfTable] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        if cfg.dtype not in _DTYPES:
            raise ValueError(f"dtype={cfg.dtype!r}: the compute dtype is one "
                             f"of {_DTYPES}")
        # JAX casts its compute on a TPU only; the port on the card only
        self.cast = cfg.dtype == "bfloat16" and self.device.type == "cuda"
        self.mesh = mesh
        self.data_group, self.data_rank, self.data_size = axis(mesh, "data")
        # the rank that writes checkpoints and JSON sidecars
        self.is_writer = mesh is None or dist.get_rank() == 0
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
        # the dropout stream of the training steps, on the device; one a
        # data rank (the model ranks of one data block draw alike)
        self.generator = torch.Generator(device=self.device).manual_seed(
            cfg.seed + self.data_rank)
        # the captioner's tensor-parallel leaves held in shards: {"i2t": ..}
        self.shards: Dict[str, ModelShards] = {}
        if mesh is not None:
            self._place()
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

    def _models(self):
        return (("i2t", self.i2t_model), ("nmt", self.nmt_model))

    @torch.no_grad()
    def _place(self) -> None:
        """Every rank takes global rank 0's parameters; on a model axis of
        more than one rank the captioner's model-sharded leaves are cut to
        shards (the JAX dry run places the captioner's tree so; the NMT
        stays replicated, as there: its target vocabulary, 8,571 at the
        recipe's width, does not divide a model axis of 2)."""
        for _, model in self._models():
            for p in (model.parameters() if model is not None else ()):
                broadcast_(p.data, src=0)
        if axis(self.mesh, "model")[2] == 1 or self.i2t_model is None:
            return
        placements = param_sharding(self._params(self.i2t_model), self.mesh,
                                    tensor_parallel=True)
        shards = ModelShards(self.i2t_model, self.mesh, placements)
        if shards.dims:
            shards.shard()
            self.shards["i2t"] = shards

    def _unshard(self) -> None:
        for shards in self.shards.values():
            shards.unshard()

    def _reshard(self) -> None:
        for shards in self.shards.values():
            shards.shard()

    def _batch(self, data: Dict[str, Any], keys=_BATCH_KEYS
               ) -> Dict[str, torch.Tensor]:
        """The batch on the device: f64 arrays as f32 (JAX's canonical
        float), ids as int64, and with `cfg.dtype` "bfloat16" the f32
        features rounded to bf16 on the host before the upload, bit for
        bit as ml_dtypes rounds (`data.dataloader.to_bfloat16`)."""
        out = {}
        for k in keys:
            if data.get(k) is None:
                continue
            v = data[k]
            v = v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v))
            if v.dtype == torch.float64:
                v = v.to(torch.float32)
            elif not v.is_floating_point() and v.dtype != torch.bool:
                v = v.to(torch.int64)       # ids: labels, gts, NMT batches
            if (self.cfg.dtype == "bfloat16" and k in FEATURE_KEYS
                    and v.dtype == torch.float32):
                v = to_bfloat16(v)
            out[k] = v.to(self.device, non_blocking=True)
        return out

    def _compute_params(self):
        """`bf16_params` of both models on the cast route (`self.cast`);
        nothing otherwise."""
        if not self.cast:
            return contextlib.nullcontext()
        return bf16_params(*(m for _, m in self._models() if m is not None))

    def _update(self, params, tx, state, lr: float, shards=None):
        """One transform step of `params` from their .grad (zeros where
        there is none); returns the new transform state. Under a mesh the
        gradients are first summed over the data axis; with `shards` the
        clip reads the whole gradient's norm, then the model-sharded
        parameters and their gradients go back to this rank's shards."""
        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for k, p in params.items()}
        if self.data_group is not None and self.data_size > 1:
            flat = torch.cat([g.reshape(-1) for g in grads.values()])
            all_reduce_(flat, self.data_group)
            grads = dict(zip(grads, (f.view_as(g) for f, g in zip(
                flat.split([g.numel() for g in grads.values()]),
                grads.values()))))
        sq_norm = None
        if shards is not None:
            sq_norm = global_sq_norm(grads)
            shards.shard()
            grads = {k: (shards.slice(k, g) if k in shards.dims else g)
                     for k, g in grads.items()}
        upd, state = tx.update(grads, state, params, global_sq_norm=sq_norm)
        keys = list(params)
        torch._foreach_add_([params[k] for k in keys],
                            [upd[k] for k in keys], alpha=-lr)
        return state

    def _nmt_terms(self, data, metrics: Dict[str, torch.Tensor]):
        """The NMT loss and the losses coupled to it; returns their sum."""
        cfg = self.cfg
        nb = self._batch(data["nmt"], _NMT_KEYS)
        src, lengths, tgt = nb["src"].long(), nb["lengths"].long(), \
            nb["tgt"].long()
        # `word￨feat` streams ride only when the corpus has them (only the
        # BiLSTM NMT takes them, as in JAX)
        fk = {"src_feats": nb["src_feats"]} if "src_feats" in nb else {}
        nmt = self.nmt_model
        # the plain generator's NLL also for a copy-attention NMT, as the
        # JAX trainer: its copy gate and copy attention get no gradient
        outs, _ = nmt.forward(src, lengths, tgt, training=True,
                              generator=self.generator, **fk)
        logits = nmt.generator_logits(outs)
        nmt_l, stats = nmt_loss(logits, tgt[:, 1:],
                                label_smoothing=cfg.label_smoothing)
        metrics.update(nmt_loss=nmt_l, nmt_ppl=stats.ppl(),
                       nmt_acc=stats.accuracy(), nmt_words=stats.n_words)
        total = nmt_l
        # the losses on parameters alone count once: on data rank 0
        once = self.data_rank == 0
        if self.joint_vocab is not None and self.i2t_model is not None:
            cap_rows, src_rows = self.joint_vocab
            wemb = weight_trans_loss(self.i2t_model.embed,
                                     nmt.src_embedding(), cap_rows, src_rows)
            metrics["wemb_loss"] = wemb
            if once:
                total = total + wemb
        if cfg.nmt_kld_train_flag and self.nmt_teacher is not None:
            with torch.no_grad():
                t_outs, _ = self.nmt_teacher.forward(src, lengths, tgt,
                                                     **fk)
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
            if once:
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
        Under a mesh each rank passes its data rank's block of the global
        batch (`parallel.shard_batch`). Returns host floats (the global
        batch's)."""
        cfg = self.cfg
        lr_i2t = float(self.optim.i2t_lr(self.epoch))
        lr_nmt = float(self.optim.nmt_lr(self.epoch_nmt))
        ss_prob = float(self.optim.ss_prob(self.epoch))
        train_i2t = self.i2t_model is not None and cfg.i2t_train_flag
        train_nmt = self.nmt_model is not None and cfg.nmt_train_flag
        self._unshard()
        try:
            with data_parallel(self.data_group):
                metrics = self._step(data, sc_flag, train_i2t, train_nmt,
                                     lr_i2t, lr_nmt, ss_prob)
        finally:
            self._reshard()
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

    def _step(self, data, sc_flag, train_i2t, train_nmt, lr_i2t, lr_nmt,
              ss_prob) -> Dict[str, torch.Tensor]:
        """The losses, the backward and both updates of one step (inside
        the data axis' `data_parallel` block, parameters whole)."""
        metrics: Dict[str, torch.Tensor] = {}
        i2t_params = self._params(self.i2t_model)
        nmt_params = self._params(self.nmt_model)
        for params in (i2t_params, nmt_params):
            for p in (params or {}).values():
                p.grad = None
        # use_bn: the XE forward collects the batch moments, and they are
        # blended into the running statistics after the update
        with self._compute_params():
            total, bn_aux = self._losses(data, sc_flag, train_i2t, train_nmt,
                                         ss_prob, metrics)
            if total is not None:
                total.backward()
        if total is not None:
            with torch.no_grad():
                if train_i2t:
                    self.optim.i2t_state = self._update(
                        i2t_params, self.optim.i2t_tx, self.optim.i2t_state,
                        lr_i2t, self.shards.get("i2t"))
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
        # each rank's share of the additive losses -> the global batch's
        for k in ("i2t_loss", "nmt_loss", "nmt_kld", "total_loss",
                  "avg_reward"):
            if k in metrics:
                metrics[k] = global_sum(metrics[k].detach())
        return metrics

    def _losses(self, data, sc_flag, train_i2t, train_nmt, ss_prob,
                metrics: Dict[str, torch.Tensor]):
        """The step's forward: (the summed loss or None, the use_bn moments
        or None), filling `metrics`."""
        terms = []
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
                metrics["avg_reward"] = mean_share(rewards)
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
        if not terms:
            return None, bn_aux
        return sum(terms[1:], terms[0]), bn_aux

    def eval(self, loader, *, nmt_valid=None, num_images: int = -1,
             beam_size: Optional[int] = None, language_eval_refs=None
             ) -> dict:
        """Validation pass with best-CIDEr / best-NMT-acc tracking
        (parity: trainer.py:195-215). Returns the eval_split dict plus
        {'is_best': bool}."""
        from ..eval.eval_utils import eval_split

        with self.whole_params():
            out = eval_split(self.i2t_model, loader, split="val",
                             num_images=num_images,
                             beam_size=beam_size or self.cfg.beam_size,
                             language_eval_refs=language_eval_refs,
                             model_id=self.cfg.id, nmt_model=self.nmt_model,
                             nmt_valid=nmt_valid, mesh=self.mesh)
        score = (out.get("lang_stats") or {}).get("CIDEr", -out["loss"])
        out["is_best"] = self.best_cider is None or score > self.best_cider
        if out["is_best"]:
            self.best_cider = score
        if out.get("nmt_stats"):
            acc = out["nmt_stats"]["valid_acc"]
            if self.best_nmt_acc is None or acc > self.best_nmt_acc:
                self.best_nmt_acc = acc
        return out

    @contextlib.contextmanager
    def whole_params(self):
        """Within the block the tensor-parallel leaves are whole on every
        rank (a collective: every rank enters it), so the models decode,
        evaluate or save as on one device."""
        self._unshard()
        try:
            yield
        finally:
            self._reshard()

    def infos(self, loader_state: Optional[dict] = None, **extra) -> dict:
        """The infos sidecar of a checkpoint: the counters, the best
        scores, the config, the loader state and the generator's state
        (the JAX package's `rng`; this rank's)."""
        return {"iter": self.iteration, "epoch": self.epoch,
                "epoch_nmt": self.epoch_nmt, "best_cider": self.best_cider,
                "best_nmt_acc": self.best_nmt_acc,
                "opt": self.cfg.to_dict(), "loader_state": loader_state,
                "generator": self.generator.get_state().tolist(), **extra}

    def _optim_state(self) -> dict:
        """`DualOptim.state_dict()` with the sharded moments whole."""
        state = self.optim.state_dict()
        for key, shards in self.shards.items():
            state[f"{key}_state"] = [
                {f: ({k: (shards.gather(k, t) if k in shards.dims else t)
                      for k, t in v.items()} if isinstance(v, dict) else v)
                 for f, v in part.items()}
                for part in state[f"{key}_state"]]
        return state

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
        `TransformerNMTModel(**rest)` rebuilds it. Under a mesh every rank
        calls it (the shards are gathered) and global rank 0 writes whole
        tensors; the infos hold data rank 0's generator and every data
        rank's in `data_generators`."""
        infos = self.infos(loader_state)
        if self.data_size > 1:
            infos["data_generators"] = gather_objects(infos["generator"],
                                                      self.data_group)
        optim_state = self._optim_state()
        with self.whole_params():
            if self.is_writer:
                self.ckpt.save(
                    i2t_state=(self.i2t_model.state_dict()
                               if self.i2t_model is not None else None),
                    nmt_state=(self.nmt_model.state_dict()
                               if self.nmt_model is not None else None),
                    optim_state=optim_state, infos=infos,
                    histories=histories, best=best)
        if self.nmt_model is not None and self.is_writer:
            kind = ("transformer" if isinstance(self.nmt_model,
                                                TransformerNMTModel)
                    else "rnn")
            save_json(os.path.join(self.ckpt.dir, "nmt_config.json"),
                      {"model_type": kind, **self.nmt_model.init_args})
        if self.mesh is not None:
            dist.barrier()   # the files are there before any rank reads

    def load(self, best: bool = False) -> dict:
        """Restore a checkpoint of `cfg.checkpoint_path` onto the trainer's
        device: parameters, optimizer state, counters, best scores and the
        generator. Returns the infos (with the loader state)."""
        infos = self.ckpt.load_infos(best=best)
        check_resume_compat(infos.get("opt", {}), self.cfg)
        with self.whole_params():
            for name, model in (("model_i2t", self.i2t_model),
                                ("model_nmt", self.nmt_model)):
                if model is not None:
                    model.load_state_dict(self.ckpt.load_params(
                        name, best=best, device=self.device))
        optim_state = self.ckpt.load_params("optimizer", best=best,
                                            device=self.device)
        for key, shards in self.shards.items():
            optim_state[f"{key}_state"] = [
                {f: ({k: (shards.slice(k, t) if k in shards.dims else t)
                      for k, t in v.items()} if isinstance(v, dict) else v)
                 for f, v in part.items()}
                for part in optim_state[f"{key}_state"]]
        self.optim.load_state_dict(optim_state, device=self.device)
        self.iteration = infos["iter"]
        self.epoch = infos["epoch"]
        self.epoch_nmt = infos["epoch_nmt"]
        self.best_cider = infos.get("best_cider")
        self.best_nmt_acc = infos.get("best_nmt_acc")
        state = infos.get("generator")
        per_rank = infos.get("data_generators")
        if per_rank is not None and len(per_rank) == self.data_size:
            state = per_rank[self.data_rank]
        if state is not None:
            self.generator.set_state(torch.tensor(state, dtype=torch.uint8))
        return infos
