"""Ensemble evaluation CLI (counterpart of
`unpaired_image_captioning_tpu/cli/eval_ensemble.py`).

Loads the `-best` checkpoint of each run dir in `--ids` through
`CheckpointManager`, wraps the captioners in `models.ensemble.AttEnsemble`
(probability-space averaging), beam-decodes the test split and scores it.
Runs on the card unless `--device` names another:

    python -m unpaired_image_captioning_tpu_torch.cli.eval_ensemble \\
        --ids run_fc run_topdown --beam_size 5 --language_eval 1 \\
        [--device cpu]

The test split is read with the first run's data paths and options (its
`infos-best.json`), at `--batch_size` images a batch. Writes
`eval_results/ensemble_test.json` under the working directory.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def main(argv=None):
    import torch

    from .. import models
    from ..config import Config
    from ..eval.eval_utils import language_eval
    from ..models.base import Features, resolve_device
    from ..models.ensemble import AttEnsemble
    from ..train.checkpoint import CheckpointManager
    from ..utils.text import decode_sequence
    from .train import build_loader

    p = argparse.ArgumentParser("eval_ensemble")
    p.add_argument("--ids", nargs="+", required=True, help="run dirs")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--beam_size", type=int, default=5)
    p.add_argument("--num_images", type=int, default=-1)
    p.add_argument("--language_eval", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args, _ = p.parse_known_args(argv)
    device = resolve_device(args.device)

    members = []
    cfg0 = None
    for run_dir in args.ids:
        ckpt = CheckpointManager(run_dir)
        cfg = Config.from_dict(ckpt.load_infos(best=True)["opt"])
        m = models.setup(cfg, device=device)
        m.load_state_dict(ckpt.load_params("model_i2t", best=True,
                                           device=device))
        m.eval()
        members.append(m)
        cfg0 = cfg0 or cfg
    ens = AttEnsemble(members)

    cfg0.batch_size = args.batch_size
    loader = build_loader(cfg0)
    loader.reset_iterator("test")
    budget = (len(loader.split_ix["test"]) if args.num_images <= 0
              else args.num_images)

    def up(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32,
                               device=device)

    preds, seen = [], set()
    while len(seen) < budget:
        data = loader.get_batch("test")
        first = np.arange(0, data["fc_feats"].shape[0], loader.seq_per_img)
        feats = Features(fc_feats=up(data["fc_feats"][first]),
                         att_feats=up(data["att_feats"][first]),
                         attri_feats=up(data["attri_feats"][first]),
                         att_masks=up(data["att_masks"][first]))
        seq = ens.sample_beam(feats, beam_size=args.beam_size).seq[:, 0]
        caps = decode_sequence(loader.vocab.ix_to_word, seq.cpu().numpy())
        for info, cap in zip(data["infos"], caps):
            if info["id"] not in seen:
                seen.add(info["id"])
                preds.append({"image_id": info["id"], "caption": cap})
        if data["bounds"]["wrapped"]:
            break
    preds = preds[:budget]

    out = {"predictions": preds}
    if args.language_eval:
        refs = loader.references("test")
        out["overall"] = language_eval("ensemble", preds, "ensemble", "test",
                                       references=refs)
        print(json.dumps(out["overall"], indent=1))
    os.makedirs("eval_results", exist_ok=True)
    path = "eval_results/ensemble_test.json"
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print("wrote", path)
    return out


if __name__ == "__main__":
    main()
