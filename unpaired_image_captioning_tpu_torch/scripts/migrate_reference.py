"""Migrate a reference run into the port (counterpart of
`unpaired_image_captioning_tpu/scripts/migrate_reference.py`).

One command takes the artifacts a user of the reference already has —
`model_i2t-best.pth` / `model_nmt-best.pth` torch checkpoints
(trainer.py:98-104), `infos-best.pkl`, the `wtoi_zh.txt` vocab pickle, and
`nmt.{train,dicts}.pt` corpora (scripts/prepro_aic_nmt.py) — and emits a
run directory in the port's format, which `cli.eval_unpaired` and
`cli.eval_paired` load with `--start_from`:

    model_i2t-best.pt   (models/convert.py, gate order fixed; torch.save
    model_nmt-best.pt    of the state dict, as train/checkpoint.py writes)
    infos-best.json     (config + vocab)
    src_dict.json / tgt_dict.json
    nmt.train.npz

As in the JAX package, it writes no `nmt_config.json`, so `cli.translate`
does not read a migrated directory. The state dicts load with
`torch.load(weights_only=True)`; the corpus, which pickles lists, dicts
and onmt `Dict` objects, with `weights_only=False`
(`NMTDataset.from_reference_pt`). Needs no card.

    python -m unpaired_image_captioning_tpu_torch.scripts.migrate_reference \\
        --out_dir run --caption_model denseatt --i2t_pth model_i2t-best.pth \\
        --nmt_pth model_nmt-best.pth --infos_pkl infos-best.pkl \\
        --wtoi_zh wtoi_zh.txt --nmt_pt nmt.train.pt
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np


def load_torch_state(path: str) -> dict:
    """A reference `.pth` state dict (or `{"model": state dict}`) as numpy
    arrays by name."""
    import torch

    blob = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(blob, dict) and "model" in blob and hasattr(
            blob["model"], "items"):
        blob = blob["model"]
    return {k: v.numpy() for k, v in blob.items() if hasattr(v, "numpy")}


def main(argv=None):
    from ..bridge import params_from_jax
    from ..config import Config
    from ..data.nmt_dataset import NMTDataset
    from ..models.convert import CONVERTERS, convert_nmt_model
    from ..train.checkpoint import CheckpointManager, save_json
    from ..vocab import CaptionVocab, Dict

    p = argparse.ArgumentParser("migrate_reference")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--caption_model", default="fc",
                   choices=sorted(CONVERTERS))
    p.add_argument("--i2t_pth", help="reference model_i2t[-best].pth")
    p.add_argument("--nmt_pth", help="reference model_nmt[-best].pth")
    p.add_argument("--wtoi_zh", help="reference wtoi_zh.txt pickle")
    p.add_argument("--nmt_pt", help="reference nmt.train.pt corpus")
    p.add_argument("--infos_pkl", help="reference infos[-best].pkl")
    p.add_argument("--nmt_layers", type=int, default=1)
    p.add_argument("--brnn", type=int, default=1)
    args = p.parse_args(argv)

    os.makedirs(args.out_dir, exist_ok=True)
    ckpt = CheckpointManager(args.out_dir)
    infos = {"opt": {"caption_model": args.caption_model}, "iter": 0,
             "epoch": 0, "epoch_nmt": 0, "migrated_from": "reference"}

    if args.infos_pkl:
        import pickle

        # the reference wrote it under python 2
        with open(args.infos_pkl, "rb") as f:
            ref_infos = pickle.load(f, encoding="latin-1")
        opt = ref_infos.get("opt")
        if opt is not None:
            known = {f.name for f in dataclasses.fields(Config)}
            infos["opt"].update({k: v for k, v in vars(opt).items()
                                 if k in known and isinstance(
                                     v, (int, float, str, bool, type(None)))})
        if "vocab" in ref_infos:
            CaptionVocab(ref_infos["vocab"])  # validate
            infos["vocab"] = ref_infos["vocab"]
        infos["iter"] = ref_infos.get("iter", 0)
        infos["epoch"] = ref_infos.get("epoch", 0)

    if args.wtoi_zh:
        vocab = CaptionVocab.from_wtoi_pickle(args.wtoi_zh)
        infos["vocab"] = vocab.ix_to_word
        infos["opt"]["vocab_size"] = vocab.vocab_size
        print(f"vocab: {vocab.vocab_size} zh entries")

    if args.i2t_pth:
        state = load_torch_state(args.i2t_pth)
        params = CONVERTERS[args.caption_model](state)
        ckpt.save(i2t_state=params_from_jax(params), best=True)
        print(f"converted i2t ({args.caption_model}): {len(state)} tensors")

    if args.nmt_pth:
        state = load_torch_state(args.nmt_pth)
        params = convert_nmt_model(state, layers=args.nmt_layers,
                                   brnn=bool(args.brnn))
        ckpt.save(nmt_state=params_from_jax(params), best=True)
        src_v, dim = params["encoder"]["embeddings"]["word_lut"].shape
        tgt_v = params["decoder"]["embeddings"]["word_lut"].shape[0]
        infos["opt"].update({"nmt_src_vocab_size": int(src_v),
                             "nmt_tgt_vocab_size": int(tgt_v),
                             "word_vec_size": int(dim),
                             "layers": args.nmt_layers,
                             "brnn": bool(args.brnn)})
        print(f"converted nmt: src={src_v} tgt={tgt_v}")

    if args.nmt_pt:
        import torch

        blob = torch.load(args.nmt_pt, map_location="cpu",
                          weights_only=False)
        if "dicts" in blob:
            for side in ("src", "tgt"):
                d = Dict()
                ref_d = blob["dicts"][side]
                # onmt.Dict pickles carry idxToLabel/labelToIdx attributes
                i2l = getattr(ref_d, "idxToLabel", None) or ref_d
                for ix, label in i2l.items():
                    d.add(label, int(ix))
                save_json(os.path.join(args.out_dir, f"{side}_dict.json"),
                          d.state_dict())
                print(f"{side} dict: {d.size()} entries")
        ds = NMTDataset.from_reference_pt(args.nmt_pt, batch_size=1)
        np.savez(os.path.join(args.out_dir, "nmt.train.npz"), src=ds.src,
                 tgt=ds.tgt)
        print(f"corpus: {len(ds.src)} pairs")

    ckpt.save(infos=infos, best=True)
    print(f"wrote {args.out_dir}/infos-best.json — load with "
          f"--start_from {args.out_dir}")


if __name__ == "__main__":
    main()
