"""The multi-rank dry run (the port's twin of `dryrun_multichip` in the
JAX package's `__graft_entry__.py`).

`dryrun_multichip(n, device=...)` starts n ranks (`launch.run_ranks`) on a
("data", "model") mesh of n/2 x 2 when n >= 4 and n is even, else on a
1-D "data" mesh, and runs the whole training and decode surface at the
dry run's tiny sizes under it:

1. a joint XE step (captioner XE, NMT NLL, Weight_Trans, both updates),
   with the captioner's tensor-parallel placements on a 2-D mesh;
2. an SCST step on a real CIDEr-D df table;
3. a beam-3 caption decode of each data rank's rows, gathered;
4. `pivot_translate` (caption beam -> id map -> NMT beam) on the same rows;
5. a transformer-NMT step and a beam-3 translate;
6. a checkpoint round trip under the mesh: a fresh trainer with the same
   placements loads it, its leaves keep their shard shapes and equal the
   saved ones, and it takes one more step.

Each step's losses must be finite. Returns rank 0's report (the mesh and
the step metrics). On "cpu" the ranks talk over gloo; on "cuda" each rank
takes its own card over NCCL, so n cards are needed.

    python -m unpaired_image_captioning_tpu_torch.parallel.dryrun 4 --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import tempfile

import numpy as np
import torch


def _tiny_cfg(checkpoint_path: str):
    from ..config import Config

    return Config(
        caption_model="denseatt", vocab_size=31, rnn_size=32, num_layers=1,
        input_encoding_size=16, att_hid_size=16, fc_feat_size=32,
        att_feat_size=24, attri_feat_size=16, seq_length=8,
        drop_prob_lm=0.3, batch_size=8, seq_per_img=1, i2t_train_flag=True,
        nmt_train_flag=True, nmt_src_vocab_size=32, nmt_tgt_vocab_size=32,
        word_vec_size=16, layers=1, dropout=0.2,
        checkpoint_path=checkpoint_path)


def _finite(metrics: dict, what: str) -> None:
    for k, v in metrics.items():
        if not math.isfinite(v):
            raise AssertionError(f"non-finite {what} metric {k}: {v}")


def _shard_shapes(trainer) -> dict:
    return {f"{key}.{k}": tuple(s.params[k].shape)
            for key, s in trainer.shards.items() for k in s.dims}


def _whole(trainer) -> dict:
    with trainer.whole_params():
        return {f"{key}.{k}": v.detach().cpu().clone()
                for key, model in trainer._models() if model is not None
                for k, v in model.state_dict().items()}


def _rank(rank: int, world: int, device_type: str, ckpt_dir: str) -> dict:
    import torch.distributed as dist

    from ..eval.metrics.cider import compute_doc_freq, precook
    from ..models.base import Features
    from ..ops.cider import build_df_table
    from ..pivot import pivot_translate
    from ..train.trainer import Trainer
    from .mesh import axis, gather_objects, make_mesh, shard_batch

    torch.set_num_threads(1)
    device = torch.device(f"cuda:{rank}" if device_type == "cuda" else "cpu")
    shape = f"{world // 2}x2" if world >= 4 and world % 2 == 0 else "data"
    mesh = make_mesh(world, shape)
    group, _, d_size = axis(mesh, "data")
    cfg = _tiny_cfg(ckpt_dir)

    # Weight_Trans rows and a real (tiny) df table
    joint_vocab = (np.arange(1, 9), np.arange(4, 12))
    rng0 = np.random.RandomState(11)
    refs = [" ".join(str(t) for t in rng0.randint(1, 31, 6))
            for _ in range(16)]
    df_words = compute_doc_freq([[precook(s)] for s in refs])
    df_ids = {tuple(int(x) for x in ng): v for ng, v in df_words.items()}

    def trainer(c=cfg, **kw):
        return Trainer(c, device=device, mesh=mesh, **kw)

    tr = trainer(joint_vocab=joint_vocab,
                 df_table=build_df_table(df_ids, 16.0, device=device))
    b = max(8, d_size)
    rng = np.random.RandomState(0)
    batch = {
        "fc_feats": rng.randn(b, cfg.fc_feat_size).astype(np.float32),
        "att_feats": rng.randn(b, 6, cfg.att_feat_size).astype(np.float32),
        "attri_feats": rng.randn(b, cfg.attri_feat_size).astype(np.float32),
        "att_masks": np.ones((b, 6), np.float32),
        "labels": rng.randint(0, cfg.vocab_size,
                              (b, cfg.seq_length + 2)).astype(np.int64),
        "masks": np.ones((b, cfg.seq_length + 2), np.float32),
        "gts": rng.randint(0, cfg.vocab_size,
                           (b, 2, cfg.seq_length)).astype(np.int64),
        "gts_masks": np.ones((b, 2), np.float32),
        "nmt": {
            "src": rng.randint(4, cfg.nmt_src_vocab_size,
                               (b, 7)).astype(np.int64),
            "tgt": rng.randint(4, cfg.nmt_tgt_vocab_size,
                               (b, 8)).astype(np.int64),
            "lengths": np.full((b,), 7, np.int64),
        },
    }
    mine = shard_batch(batch, mesh)    # this data rank's block
    metrics = tr.train(mine)
    if "wemb_loss" not in metrics:
        raise AssertionError("the Weight_Trans branch did not run")
    _finite(metrics, "joint XE")
    metrics_rl = tr.train(mine, sc_flag=True)
    if "avg_reward" not in metrics_rl:
        raise AssertionError("the SCST branch did not run")
    _finite(metrics_rl, "SCST")

    # this data rank's rows: a beam-3 decode and the fused pivot, gathered
    def rows(x):
        return torch.as_tensor(x, device=device)

    feats = Features(fc_feats=rows(mine["fc_feats"]),
                     att_feats=rows(mine["att_feats"]), attri_feats=None,
                     att_masks=rows(mine["att_masks"]))
    cap2nmt = np.minimum(np.arange(cfg.vocab_size + 1),
                         cfg.nmt_src_vocab_size - 1)
    cap2nmt[0] = 0
    with tr.whole_params(), torch.no_grad():
        seq = tr.i2t_model.sample_beam(feats, beam_size=3).seq[:, 0]
        zh, en, attn_argmax = pivot_translate(
            tr.i2t_model, tr.nmt_model, feats,
            torch.as_tensor(cap2nmt, device=device), cap_beam=3, nmt_beam=5,
            nmt_max_len=12)
    seq = np.concatenate(gather_objects(seq.cpu().numpy(), group))
    if seq.shape != (b, cfg.seq_length):
        raise AssertionError(f"beam decode {seq.shape}")
    zh_all = np.concatenate(gather_objects(zh.cpu().numpy(), group))
    en_rows = sum(gather_objects(int(en.shape[0]), group))
    if zh_all.shape != (b, cfg.seq_length) or en_rows != b or \
            attn_argmax.shape[0] != len(mine["fc_feats"]):
        raise AssertionError(f"pivot zh {zh_all.shape}, en rows {en_rows}")

    # the transformer NMT under the same mesh: a step and a beam translate
    tf_cfg = dataclasses.replace(
        cfg, i2t_train_flag=False, nmt_model_type="transformer",
        word_vec_size=16, rnn_size=32, layers=2, num_heads=2,
        checkpoint_path=ckpt_dir + "/tfnmt")
    tr_tf = trainer(tf_cfg)
    m_tf = tr_tf.train({"nmt": mine["nmt"]})
    _finite(m_tf, "transformer NMT")
    with tr_tf.whole_params(), torch.no_grad():
        res_tf = tr_tf.nmt_model.translate_batch(
            rows(mine["nmt"]["src"]), rows(mine["nmt"]["lengths"]),
            beam_size=3, max_len=10)
    tf_rows = sum(gather_objects(int(res_tf.seq.shape[0]), group))
    if tf_rows != b:
        raise AssertionError(f"transformer translate {tf_rows} rows")

    # the checkpoint round trip under the mesh
    tr.save()
    tr2 = trainer(joint_vocab=joint_vocab,
                  df_table=build_df_table(df_ids, 16.0, device=device))
    template = _shard_shapes(tr2)
    tr2.load()
    if tr2.iteration != tr.iteration:
        raise AssertionError((tr2.iteration, tr.iteration))
    if _shard_shapes(tr2) != template or template != _shard_shapes(tr):
        raise AssertionError("the placements did not survive the load")
    want, got = _whole(tr), _whole(tr2)
    for k, v in want.items():
        if not torch.equal(v, got[k]):
            raise AssertionError(f"{k} differs after the round trip")
    resumed = tr2.train(mine)
    _finite(resumed, "resumed")
    if dist.get_rank() != 0:
        return {}
    return {"mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
            "total_loss": metrics["total_loss"],
            "wemb_loss": metrics["wemb_loss"],
            "avg_reward": metrics_rl["avg_reward"],
            "beam": list(seq.shape), "pivot_zh": list(zh_all.shape),
            "transformer_nmt_loss": m_tf["total_loss"],
            "sharded_leaves": len(template),
            "resumed_loss": resumed["total_loss"]}


def dryrun_multichip(n_devices: int, *, device: str = "cuda",
                     timeout: float = 600.0) -> dict:
    """Run the dry run on `n_devices` ranks (see the module's doc); raise
    if any rank fails. Returns rank 0's report."""
    from ..models.base import resolve_device
    from .launch import run_ranks

    kind = resolve_device(device).type
    devices = None
    if kind == "cuda":
        if torch.cuda.device_count() < n_devices:
            raise ValueError(f"dryrun_multichip({n_devices}) on the card "
                             f"needs {n_devices} cards, "
                             f"{torch.cuda.device_count()} visible")
        from ..kernels import build

        build.load()     # the ranks load the built library, not race for it
        devices = [f"cuda:{r}" for r in range(n_devices)]
    with tempfile.TemporaryDirectory(prefix="dryrun-") as ckpt_dir:
        reports = run_ranks(_rank, n_devices, (kind, ckpt_dir),
                            backend="nccl" if kind == "cuda" else "gloo",
                            timeout=timeout, devices=devices)
    report = reports[0]
    print(f"dryrun_multichip OK: {json.dumps(report)}")
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_devices", type=int)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)
    dryrun_multichip(args.n_devices, device=args.device,
                     timeout=args.timeout)


if __name__ == "__main__":
    main()
