"""Unpaired (pivot) evaluation CLI, the in-process two-model path
(counterpart of `unpaired_image_captioning_tpu/cli/eval_unpaired.py`).

Parity: reference `eval_unpaired.py:412-482` (`eval`) — load the i2t
captioner and the NMT translator, decode zh captions for COCO images, run
the zh→en translation in-process (here in one `pivot.pivot_translate` call
on the device), post-edit, score en vs COCO refs; self-BLEU diversity
(:282-287). Runs on the card unless `--device` names another:

    python -m unpaired_image_captioning_tpu_torch.cli.eval_unpaired \\
        --start_from run --input_json talk.json --input_label_h5 label.npz \\
        --input_fc_dir fc --input_att_dir att --beam_size 5 \\
        --language_eval 1 --input_coco_json coco_refs.json [--device cpu]

`--start_from` is a run directory of `cli.train` or of
`scripts.migrate_reference`. `--eval_30k captions.txt` scores a text file
instead (`eval_30k`).
"""

from __future__ import annotations

import json
import os


def eval_30k(text_in: str, *, mode: str = "offline", nmt_run: str = "",
             flickr_refs: str = "", flickr_ids: str = "",
             model_id: str = "30k", device: str = "cuda") -> dict:
    """flickr30k route (parity: eval_unpaired.py `eval_30K` :289-325).

    `text_in`: one caption per line. mode='offline' treats the lines as
    already-English pivot output and applies the reference's post-edit
    (strip "there is", lowercase, :303-319); mode='online' first translates
    the lines with the NMT of run dir `nmt_run` through the standalone
    translate CLI on `device` (the reference's googletrans client is
    replaced: no network).
    Scores vs `flickr_refs` (json: image_id -> [reference captions], the
    flickr30k_val.json role); ids come from `flickr_ids` (json list, the
    ref-results-json id source, :321-323) or enumerate."""
    from ..eval.eval_utils import language_eval
    from ..utils.text import text2cocojson

    if mode == "online":
        assert nmt_run, "--eval_30k online mode needs --start_from <nmt run>"
        from . import translate as translate_cli

        translated = os.path.join("tmp", "flickr_30k_nmt_out.txt")
        os.makedirs("tmp", exist_ok=True)
        translate_cli.main(["-model", nmt_run, "-src", text_in,
                            "-output", translated, "-device", device])
        text_in = translated

    with open(text_in, encoding="utf-8") as f:
        lines = [l.rstrip("\n") for l in f]
    en_lines = [l.replace("there is", "").strip().lower() for l in lines]

    os.makedirs("tmp", exist_ok=True)
    tmp_name = os.path.join("tmp", f"flickr_test_1k_en_{mode}")
    with open(tmp_name + ".txt", "w", encoding="utf-8") as f:
        for line in en_lines:
            f.write(line + "\n")

    if flickr_ids:
        with open(flickr_ids) as f:
            ids = json.load(f)
    else:
        ids = list(range(len(en_lines)))
    text2cocojson(tmp_name + ".txt", ids, tmp_name + "_id.json")

    overall = None
    if flickr_refs and os.path.exists(flickr_refs):
        with open(flickr_refs) as f:
            refs = {int(k): v for k, v in json.load(f).items()}
        with open(tmp_name + "_id.json") as f:
            preds = json.load(f)
        overall = language_eval("30k", preds, model_id, "test",
                                references=refs)
        print(json.dumps(overall, indent=1))
    return {"predictions_json": tmp_name + "_id.json", "overall": overall}


def load_run(cfg):
    """The run directory `cfg.start_from` as an eval CLI reads it: (the
    config merged with the run's, its checkpoint manager, the `-best`
    track flag)."""
    from ..config import Config, merge_checkpoint_config
    from ..train.checkpoint import CheckpointManager

    assert cfg.start_from, "--start_from <run dir> is required"
    ckpt = CheckpointManager(cfg.start_from)
    best = bool(cfg.load_best_score)
    infos = ckpt.load_infos(best=best)
    cfg = merge_checkpoint_config(cfg, Config.from_dict(infos["opt"]))
    return cfg, ckpt, best


def load_model(build, ckpt, name: str, best: bool, device):
    """`build(device)`'s model with the weights of checkpoint `name`."""
    model = build(device)
    model.load_state_dict(ckpt.load_params(name, best=best, device=device))
    model.eval()
    return model


def main(argv=None):
    from .. import models, pivot
    from ..config import parse_opt
    from ..eval.eval_utils import eval_split_coco_unpaired
    from ..models.base import resolve_device
    from ..models.nmt_transformer import make_nmt_model
    from ..train.checkpoint import load_json
    from ..utils.text import self_bleu
    from ..vocab import Dict
    from .train import build_loader

    cfg = parse_opt(argv)
    if cfg.eval_30k:
        return eval_30k(cfg.eval_30k, mode=cfg.eval_30k_mode,
                        nmt_run=cfg.start_from, flickr_refs=cfg.flickr_refs,
                        flickr_ids=cfg.flickr_ids, model_id=cfg.id,
                        device=cfg.device)
    cfg, ckpt, best = load_run(cfg)
    device = resolve_device(cfg.device)

    coco_loader = build_loader(cfg)
    cfg.vocab_size = coco_loader.vocab.vocab_size
    cfg.seq_length = coco_loader.seq_length

    cap_model = load_model(lambda d: models.setup(cfg, device=d), ckpt,
                           "model_i2t", best, device)
    nmt_model = load_model(lambda d: make_nmt_model(cfg, device=d), ckpt,
                           "model_nmt", best, device)

    src_dict = Dict.from_state_dict(load_json(
        os.path.join(cfg.start_from, "src_dict.json")))
    tgt_dict = Dict.from_state_dict(load_json(
        os.path.join(cfg.start_from, "tgt_dict.json")))
    cap2nmt = pivot.build_caption_to_nmt_map(coco_loader.vocab, src_dict)
    tgt_itos = {int(k): v for k, v in tgt_dict.idx_to_label.items()}

    en_refs = None
    if cfg.language_eval and cfg.input_coco_json and os.path.exists(
            cfg.input_coco_json):
        with open(cfg.input_coco_json) as f:
            en_refs = {int(k): v for k, v in json.load(f).items()}

    out = eval_split_coco_unpaired(
        cap_model, nmt_model, coco_loader, cap2nmt, tgt_itos, split="test",
        num_images=cfg.val_images_use, cap_beam=cfg.beam_size,
        en_refs=en_refs, model_id=cfg.id, spice=bool(cfg.spice))
    out["self_bleu"] = self_bleu([p["caption"] for p in out["en_predictions"]],
                                 sample=200)
    os.makedirs("eval_results", exist_ok=True)
    path = os.path.join("eval_results", f"unpaired_{cfg.id}_test.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print("self-BLEU:", out["self_bleu"])
    if out.get("en_lang_stats"):
        print(json.dumps(out["en_lang_stats"], indent=1))
    print("wrote", path)
    return out


if __name__ == "__main__":
    main()
