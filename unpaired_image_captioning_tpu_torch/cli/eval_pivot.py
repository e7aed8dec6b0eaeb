"""Pivot evaluation CLI, the stage-separated offline pipeline (counterpart
of `unpaired_image_captioning_tpu/cli/eval_pivot.py`).

Parity: reference `eval_pivot.py` `eval_coco_offline` (:147-193):

  1. i2t_eval (:195-227): decode zh captions for the eval images (from
     precomputed features, or from a raw ``--image_folder`` through
     `RawImageLoader` and the port's ResNet, :204-210) and dump
     ``tmp/<id>_zh_coco.json``;
  2. cocojson2text: json -> one caption per line (:152-153);
  3. the standalone translate CLI runs on the text file with the NMT of the
     run dir (the reference shells out to a separate OpenNMT process,
     :154-161; here ``cli.translate`` runs in-process, reading the run
     dir's nmt_config.json, dicts and model_nmt.pt as a separate
     invocation would);
  4. text2cocojson: hypotheses + image ids -> predictions json (:186-190);
  5. ``language_eval('coco', ...)`` scores vs the COCO refs (:191-193).

Every stage writes its artifact, so any stage can be re-run alone. On a
run dir of `cli.train` its zh and en predictions are those of
`cli.eval_unpaired`. Runs on the card unless `--device` names another:

    python -m unpaired_image_captioning_tpu_torch.cli.eval_pivot \\
        --start_from run --input_json talk.json ... [--image_folder imgs] \\
        [--device cpu]
"""

from __future__ import annotations

import json
import os


def main(argv=None):
    from .. import models
    from ..config import parse_opt
    from ..eval.eval_utils import eval_split, language_eval
    from ..models.base import resolve_device
    from ..utils.text import cocojson2text, expand_contractions, text2cocojson
    from . import translate as translate_cli
    from .eval_unpaired import load_model, load_run
    from .train import build_loader

    cfg, ckpt, best = load_run(parse_opt(argv))
    device = resolve_device(cfg.device)

    # ---- stage 1: i2t_eval -> zh json -------------------------------------
    if cfg.image_folder:
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

    cap_model = load_model(lambda d: models.setup(cfg, device=d), ckpt,
                           "model_i2t", best, device)
    out = eval_split(cap_model, loader, split="test",
                     num_images=cfg.val_images_use, beam_size=cfg.beam_size,
                     model_id=cfg.id)
    os.makedirs("tmp", exist_ok=True)
    zh_json = os.path.join("tmp", f"{cfg.id}_zh_coco.json")
    with open(zh_json, "w") as f:
        json.dump(out["predictions"], f)
    print(f"stage 1: {len(out['predictions'])} zh captions -> {zh_json}")

    # ---- stage 2: json -> txt ---------------------------------------------
    zh_txt = zh_json.replace(".json", ".txt")
    cocojson2text(zh_json, zh_txt)

    # ---- stage 3: standalone translate CLI --------------------------------
    en_txt = zh_txt.replace("_zh_", "_en_")
    translate_cli.main(["-model", cfg.start_from, "-src", zh_txt,
                        "-output", en_txt, "-beam_size", "15",
                        "-batch_size", str(cfg.batch_size),
                        "-device", str(device)])
    print(f"stage 3: translated -> {en_txt}")

    # ---- stage 4: txt -> coco predictions json ----------------------------
    ids = [p["image_id"] for p in out["predictions"]]
    en_json = en_txt.replace(".txt", ".json")
    text2cocojson(en_txt, ids, en_json)
    with open(en_json) as f:
        en_preds = json.load(f)
    # the reference post-edits the pivot output before scoring
    # (eval_utils.py:417-420); expand_contractions covers the "'s" fixups
    for p in en_preds:
        p["caption"] = expand_contractions(p["caption"])

    # ---- stage 5: language_eval -------------------------------------------
    overall = None
    if cfg.language_eval and cfg.input_coco_json and os.path.exists(
            cfg.input_coco_json):
        with open(cfg.input_coco_json) as f:
            en_refs = {int(k): v for k, v in json.load(f).items()}
        overall = language_eval("coco", en_preds, cfg.id, "test",
                                references=en_refs, spice=bool(cfg.spice))
        print(json.dumps(overall, indent=1))

    os.makedirs("eval_results", exist_ok=True)
    path = os.path.join("eval_results", f"pivot_{cfg.id}_test.json")
    with open(path, "w") as f:
        json.dump({"zh_predictions": out["predictions"],
                   "en_predictions": en_preds, "overall": overall}, f,
                  indent=1)
    print("wrote", path)
    return {"zh_predictions": out["predictions"], "en_predictions": en_preds,
            "overall": overall}


if __name__ == "__main__":
    main()
