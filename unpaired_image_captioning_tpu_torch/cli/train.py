"""Training CLI (counterpart of `unpaired_image_captioning_tpu/cli/train.py`).

Parity: reference `train.py:16-156` — init (seed, loaders, resume from the
infos sidecar with compat asserts), infinite loop: get_batch → trainer.train
→ metric logging every `losses_log_every` → eval + checkpoint (+`-best`
dual-track) every `save_checkpoint_every` → stop at `max_epochs`; the SCST
phase switch at `self_critical_after` epochs (train.sh recipe). A step that
raises leaves an emergency checkpoint (parameters and infos) before the
error propagates.

Runs on the card unless `--device` names another:

    python -m unpaired_image_captioning_tpu_torch.cli.train \\
        --caption_model denseatt --input_json data/chinese_talk.json \\
        --input_label_h5 data/chinese_talk_label.npz --i2t_train_flag true \\
        ... [--device cpu]

The label file and the NMT corpus are `.npz` or HDF5 (`data/arrays.py`).
`--input_workers N` assembles the features in N worker processes
(`data/prefetch.py`); the batches, and so the run, are bit for bit those
of `--input_workers 0`. A corpus with source-feature streams
(`src_feat_{j}`) trains the BiLSTM NMT with one feature LUT a stream.

Scale-out: `--num_devices N` (0, the default, is every visible card)
starts N ranks, one card each over NCCL (`parallel/launch.py`), on the
mesh `--mesh_shape` names ("data", or "DxM" for data x model); under
`torchrun` the CLI joins the group that is there instead. Every rank
plans the same global batch and reads only its data rank's block of it
(the loader's `data_rank`), and the trainer's step is the one-device step
on the global batch; rank 0 prints, logs and writes the checkpoints. With `--device
cpu` the ranks are CPU processes over gloo.

    torchrun --nproc_per_node 2 -m unpaired_image_captioning_tpu_torch.cli.train ...
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np


def build_loader(cfg, nmt_dataset=None, mesh=None):
    """The caption loader of `cfg`; under a scale-out `mesh` its training
    batches are this data rank's block."""
    from ..data.dataloader import CaptionDataLoader
    from ..parallel.mesh import axis

    _, data_rank, num_data_ranks = axis(mesh, "data")
    return CaptionDataLoader(
        input_json=cfg.input_json, input_label_h5=cfg.input_label_h5,
        input_fc_dir=cfg.input_fc_dir, input_att_dir=cfg.input_att_dir,
        input_box_dir=cfg.input_box_dir,
        input_box_cls_prob_dir=cfg.input_box_cls_prob_dir,
        input_fc_h5=cfg.input_fc_h5, input_att_h5=cfg.input_att_h5,
        batch_size=cfg.batch_size, seq_per_img=cfg.seq_per_img,
        use_box=cfg.use_box, norm_att_feat=cfg.norm_att_feat,
        norm_box_feat=cfg.norm_box_feat,
        use_box_cls_prob=cfg.use_box_cls_prob,
        att_feat_size=cfg.att_feat_size, attri_feat_size=cfg.attri_feat_size,
        nmt_dataset=nmt_dataset, seed=cfg.seed, data_rank=data_rank,
        num_data_ranks=num_data_ranks)


def _nmt_data(cfg):
    """The NMT train and valid corpora and dicts; copies the dicts into the
    run directory (eval_unpaired and translate read them there) and sizes
    the NMT vocabularies in `cfg`."""
    import torch.distributed as dist

    from ..data.nmt_dataset import NMTDataset
    from ..vocab import Dict as UDict

    writer = not dist.is_initialized() or dist.get_rank() == 0
    nmt_dataset = NMTDataset.from_h5(
        cfg.input_nmt_h5, cfg.batch_size, shuffle=True, seed=cfg.seed,
        curriculum=cfg.curriculum, batch_shuffle=cfg.extra_shuffle)
    nmt_valid = None
    valid_path = cfg.input_nmt_h5.replace("train", "valid")
    if valid_path != cfg.input_nmt_h5 and os.path.exists(valid_path):
        nmt_valid = NMTDataset.from_h5(valid_path, cfg.batch_size)
    nmt_dicts = {}
    if cfg.input_nmt_dict:
        with open(cfg.input_nmt_dict) as f:
            dicts = json.load(f)
        nmt_dicts = {side: UDict.from_state_dict(dicts[side])
                     for side in ("src", "tgt")}
        cfg.nmt_src_vocab_size = nmt_dicts["src"].size()
        cfg.nmt_tgt_vocab_size = nmt_dicts["tgt"].size()
        os.makedirs(cfg.checkpoint_path, exist_ok=True)
        for side in ("src", "tgt"):
            if writer:
                with open(os.path.join(cfg.checkpoint_path,
                                       f"{side}_dict.json"), "w") as f:
                    json.dump(dicts[side], f)
    if not cfg.nmt_src_vocab_size:
        cfg.nmt_src_vocab_size = int(nmt_dataset.src.max()) + 1
        cfg.nmt_tgt_vocab_size = int(nmt_dataset.tgt.max()) + 1
    if nmt_dataset.src_feats is not None and not cfg.nmt_src_feature_sizes:
        # a featured corpus (`src_feat_{j}` streams): one feature LUT per
        # stream, sized from the stream as the JAX CLI does
        cfg.nmt_src_feature_sizes = tuple(
            int(nmt_dataset.src_feats[..., j].max()) + 1
            for j in range(nmt_dataset.src_feats.shape[-1]))
    return nmt_dataset, nmt_valid, nmt_dicts


def _joint_vocabs(cfg, loader, nmt_dicts):
    """Weight_Trans rows (captioner, NMT source) whenever joint i2t + NMT
    training has the dicts to align (reference trainer.py:95,
    criterion.py:313-353), and Weight_Trans_y (the frozen COCO table, its
    rows, NMT target rows) when a COCO captioner embedding is given
    (criterion.py:366-434)."""
    from .. import pivot
    from ..vocab import CaptionVocab

    joint_vocab = joint_vocab_y = None
    if not (cfg.i2t_train_flag and cfg.nmt_train_flag and nmt_dicts):
        return joint_vocab, joint_vocab_y
    cap_rows, src_rows = pivot.build_joint_vocab(loader.vocab,
                                                 nmt_dicts["src"])
    if len(cap_rows):
        joint_vocab = (cap_rows, src_rows)
        print(f"Weight_Trans joint vocab: {len(cap_rows)} shared words")
    if cfg.input_coco_wemb and cfg.input_coco_json:
        with open(cfg.input_coco_json) as f:
            coco_vocab = CaptionVocab(json.load(f)["ix_to_word"])
        blob = np.load(cfg.input_coco_wemb)
        coco_rows, tgt_rows = pivot.build_joint_vocab(coco_vocab,
                                                      nmt_dicts["tgt"])
        if len(coco_rows):
            joint_vocab_y = (blob["embedding"], coco_rows, tgt_rows)
            print(f"Weight_Trans_y joint vocab: {len(coco_rows)} "
                  "shared words")
    return joint_vocab, joint_vocab_y


def main(argv=None):
    """Train on one device and return the trainer; under scale-out return
    rank 0's summary (`_summary`)."""
    from ..config import parse_opt
    from ..models.base import resolve_device
    from ..parallel import launch

    # the ranks parse the same arguments (a rank's own sys.argv is not
    # this process's)
    argv = list(sys.argv[1:] if argv is None else argv)
    cfg = parse_opt(argv)
    out = launch.scale_out(_rank_main, cfg, argv)
    if out is not launch.NO_SCALE_OUT:
        return out
    return _run(cfg, resolve_device(cfg.device))


def _rank_main(local_rank, world_size, argv):
    from ..config import parse_opt
    from ..parallel import launch
    from ..parallel.mesh import make_mesh

    cfg = parse_opt(argv)
    mesh = make_mesh(world_size, cfg.mesh_shape)
    return _summary(_run(cfg, launch.rank_device(cfg.device, local_rank),
                         mesh))


def _summary(trainer) -> dict:
    return {"iter": trainer.iteration, "epoch": trainer.epoch,
            "best_cider": trainer.best_cider,
            "best_nmt_acc": trainer.best_nmt_acc}


def _run(cfg, device, mesh=None):
    from ..scripts.prepro_ngrams import load_df_table
    from ..train.trainer import Trainer

    np.random.seed(cfg.seed)

    nmt_dataset = nmt_valid = None
    nmt_dicts = {}
    if cfg.nmt_train_flag and cfg.input_nmt_h5:
        nmt_dataset, nmt_valid, nmt_dicts = _nmt_data(cfg)
    loader = build_loader(cfg, nmt_dataset, mesh)
    cfg.vocab_size = loader.vocab.vocab_size
    cfg.seq_length = loader.seq_length
    joint_vocab, joint_vocab_y = _joint_vocabs(cfg, loader, nmt_dicts)

    trainer = Trainer(cfg, device=device, mesh=mesh,
                      df_table=load_df_table(cfg.cached_tokens, device),
                      joint_vocab=joint_vocab, joint_vocab_y=joint_vocab_y)
    histories: dict = {"loss_history": {}, "lr_history": {},
                       "ss_prob_history": {}, "val_result_history": {}}
    best_track = bool(cfg.load_best_score)
    if cfg.start_from and trainer.ckpt.has_checkpoint(best=best_track):
        infos = trainer.load(best=best_track)
        if infos.get("loader_state"):
            loader.load_state_dict(infos["loader_state"])
        histories = trainer.ckpt.load_histories() or histories
        print(f"resumed from iter {trainer.iteration} epoch {trainer.epoch}")

    # feature workers (the reference BlobFetcher's role): the plan stream
    # stays in this process, so the loader state a checkpoint takes is
    # that of the next unconsumed batch, workers ahead of the step or not
    prefetcher = None
    if cfg.input_workers > 0:
        from ..data.prefetch import ProcessPrefetcher

        prefetcher = ProcessPrefetcher(loader, "train",
                                       num_workers=cfg.input_workers)

    try:
        return _train_loop(cfg, trainer, loader, nmt_valid, histories,
                           prefetcher)
    finally:
        # on every exit (the end, a step that raised, an interrupt): the
        # workers and the shared memory of planned batches go with them
        if prefetcher is not None:
            prefetcher.close()


def _train_loop(cfg, trainer, loader, nmt_valid, histories, prefetcher):
    from ..train.logging import MetricLogger

    def next_train_batch():
        return prefetcher.get() if prefetcher else loader.get_batch("train")

    def loader_state():
        return prefetcher.state_dict() if prefetcher else loader.state_dict()

    logger = (MetricLogger(cfg.checkpoint_path) if trainer.is_writer
              else _NoLogger())
    t_start = time.time()
    while True:
        sc_flag = (cfg.self_critical_after >= 0
                   and trainer.epoch >= cfg.self_critical_after)
        t0 = time.time()
        data = next_train_batch()
        read_t = time.time() - t0
        t0 = time.time()
        try:
            metrics = trainer.train(data, sc_flag=sc_flag)
        except Exception as e:
            # emergency checkpoint so the run is resumable after a crash
            # (SURVEY.md §5.3: the reference's only recovery is --start_from);
            # under a mesh rank 0 writes it without a collective, its
            # parameters only where none is held in shards
            whole = not trainer.shards
            if trainer.is_writer:
                trainer.ckpt.save(
                    infos=trainer.infos(loader_state(), crash=repr(e)),
                    i2t_state=(trainer.i2t_model.state_dict()
                               if trainer.i2t_model is not None and whole
                               else None),
                    nmt_state=(trainer.nmt_model.state_dict()
                               if trainer.nmt_model is not None and whole
                               else None))
            print(f"FATAL at iter {trainer.iteration}: {e!r} — emergency "
                  f"checkpoint written to {cfg.checkpoint_path}")
            raise
        step_t = time.time() - t0

        if data["bounds"]["wrapped"]:
            trainer.epoch += 1
        if data.get("nmt_wrapped"):
            trainer.epoch_nmt += 1

        it = trainer.iteration
        if it % cfg.losses_log_every == 0:
            scalars = dict(metrics)
            scalars.update({"read_time": read_t, "step_time": step_t,
                            "epoch": trainer.epoch})
            if "nmt_words" in metrics and step_t > 0:
                # tokens/sec console stat (Statistics.output parity,
                # criterion.py:77-95)
                scalars["nmt_tok_per_s"] = metrics["nmt_words"] / step_t
            logger.add_scalars(it, scalars)
            histories["loss_history"][str(it)] = metrics.get("total_loss")
            histories["lr_history"][str(it)] = metrics.get("lr_i2t")
            histories["ss_prob_history"][str(it)] = metrics.get("ss_prob")
            msg = " ".join(f"{k}={v:.4g}" for k, v in metrics.items())
            print(f"iter {it} (epoch {trainer.epoch}) {msg} "
                  f"read={read_t:.3f}s step={step_t:.3f}s")

        if it % cfg.save_checkpoint_every == 0:
            if prefetcher is not None:
                # the eval draws captions and NMT batches from the loader's
                # generators: hand them back from the batches planned ahead
                prefetcher.rewind()
            t0 = time.time()
            val = evaluate(trainer, loader, cfg, nmt_valid=nmt_valid)
            eval_t = time.time() - t0
            best = val.pop("is_best")
            histories["val_result_history"][str(it)] = {
                k: v for k, v in val.items() if k != "predictions"}
            logger.add_scalars(it, {"val_loss": val["loss"],
                                    "eval_time": eval_t})
            if val.get("nmt_stats"):
                logger.add_scalars(it, val["nmt_stats"])
            t0 = time.time()
            trainer.save(loader_state=loader_state(), histories=histories)
            if best:
                trainer.save(loader_state=loader_state(),
                             histories=histories, best=True)
            logger.add_scalars(it, {"save_time": time.time() - t0})
            print(f"checkpoint @ iter {it}: val_loss={val['loss']:.4f} "
                  f"best_score={trainer.best_cider:.4f} best={best} "
                  f"eval={eval_t:.3f}s")

        if trainer.epoch >= cfg.max_epochs >= 0:
            # final checkpoint so short runs are always resumable/evaluable
            trainer.save(loader_state=loader_state(), histories=histories)
            if trainer.best_cider is None:
                trainer.save(loader_state=loader_state(),
                             histories=histories, best=True)
            print(f"done: {trainer.epoch} epochs, {it} iters, "
                  f"{time.time() - t_start:.1f}s")
            return trainer


class _NoLogger:
    """The metric logger of the ranks that do not write."""

    def add_scalars(self, step, scalars) -> None:
        pass


def evaluate(trainer, loader, cfg, nmt_valid=None) -> dict:
    """The val pass of `Trainer.eval` (which tracks the best CIDEr and NMT
    accuracy) over `val_images_use` images, with language_eval's
    references when `language_eval` is set."""
    refs = loader.references("val") if cfg.language_eval else None
    return trainer.eval(loader, nmt_valid=nmt_valid,
                        num_images=cfg.val_images_use,
                        language_eval_refs=refs)


if __name__ == "__main__":
    main()
