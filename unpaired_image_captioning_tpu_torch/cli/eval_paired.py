"""Paired i2t evaluation CLI (counterpart of
`unpaired_image_captioning_tpu/cli/eval_paired.py`).

Parity: reference `eval_paired.py:17-123` — load the run's `infos-best`
sidecar, apply checkpoint-opts override with consistency asserts
(:81-91 → config.merge_checkpoint_config), load `model_i2t-best`, run
`eval_split`, dump predictions + scores json. Runs on the card unless
`--device` names another:

    python -m unpaired_image_captioning_tpu_torch.cli.eval_paired \\
        --start_from run --input_json talk.json --input_label_h5 label.npz \\
        --input_fc_dir fc --input_att_dir att --language_eval 1 \\
        [--image_folder imgs] [--device cpu]

`--bn_calibrate N` re-estimates the `use_bn` running statistics from N
train batches before the eval (`models/att.py::calibrate_batch_norm`; for
converted checkpoints that lack tracked statistics). `--num_devices` above
1 raises until scale-out (ROADMAP A14).
"""

from __future__ import annotations

import json
import os


def main(argv=None):
    from .. import models
    from ..config import parse_opt
    from ..eval.eval_utils import eval_split
    from ..models.base import resolve_device
    from .eval_unpaired import load_model, load_run
    from .train import build_loader

    cfg, ckpt, best = load_run(parse_opt(argv))
    if cfg.num_devices > 1:
        raise NotImplementedError("--num_devices > 1: the port evaluates on "
                                  "one card until scale-out (ROADMAP A14)")
    device = resolve_device(cfg.device)

    if cfg.image_folder:
        # raw-image route: folder of images -> on-the-fly ResNet features
        # (ref dataloaderraw.py:25-141 via eval_pivot.py:204-210); vocab
        # comes from the run's talk.json, captions are decoded without refs
        from ..data.raw_images import RawImageLoader
        from ..vocab import CaptionVocab

        loader = RawImageLoader(
            folder_path=cfg.image_folder, batch_size=cfg.batch_size,
            image_size=cfg.image_size, depth=cfg.resnet_depth, device=device)
        with open(cfg.input_json) as f:
            loader.vocab = CaptionVocab(json.load(f)["ix_to_word"])
        cfg.vocab_size = loader.vocab.vocab_size
    else:
        loader = build_loader(cfg)
        cfg.vocab_size = loader.vocab.vocab_size
        cfg.seq_length = loader.seq_length

    model = load_model(lambda d: models.setup(cfg, device=d), ckpt,
                       "model_i2t", best, device)
    if cfg.bn_calibrate > 0 and not cfg.image_folder:
        from ..models.att import calibrate_batch_norm

        calibrate_batch_norm(model, loader, n_batches=cfg.bn_calibrate)
        print(f"BN running stats calibrated on {cfg.bn_calibrate} batches")

    refs = None
    if cfg.language_eval and not cfg.image_folder:
        refs = {}
        for split in ("val", "test"):
            refs.update(loader.references(split))

    out = eval_split(model, loader, split="test",
                     num_images=cfg.val_images_use, beam_size=cfg.beam_size,
                     language_eval_refs=refs, model_id=cfg.id,
                     verbose=True, spice=bool(cfg.spice))
    os.makedirs("eval_results", exist_ok=True)
    path = os.path.join("eval_results", f"paired_{cfg.id}_test.json")
    with open(path, "w") as f:
        json.dump({"loss": out["loss"], "predictions": out["predictions"],
                   "overall": out["lang_stats"]}, f, indent=1)
    print("loss:", out["loss"])
    if out["lang_stats"]:
        print(json.dumps(out["lang_stats"], indent=1))
    print("wrote", path)
    return out


if __name__ == "__main__":
    main()
