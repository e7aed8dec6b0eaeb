"""Evaluation harness (counterpart of the `language_eval` and `eval_split`
parts of `unpaired_image_captioning_tpu/eval/eval_utils.py`).

Parity: reference `eval_utils.py` —
- `language_eval` (:26-85): route by dataset type ('coco' en / 'zh' AIC),
  run the metric stack, cache `eval_results/<type>_<id>_<split>.json` with
  {overall, imgToEval};
- `eval_split` (:208-327): val loop computing XE loss on labeled batches,
  greedy/beam sampling, `decode_sequence`, `num_images` budget with
  pop-on-wrap, optional NMT valid ppl/acc loop (:313-317);
- `eval_split_coco_unpaired` (:329-473): the pivot eval — zh captions for
  COCO images -> zh->en NMT -> post-edit -> score en vs COCO refs and zh vs
  AIC refs, the decode and translation in one `pivot.pivot_translate`
  call on the device;
- `eval_split_coco_paired` (:476-567): plain single-model COCO eval.

Both sweeps run on the model's device: the batches upload there, and the
decoded ids (and `eval_split`'s summed losses) stay there until the sweep
ends (at most `EVAL_WINDOW` batches of ids in flight), so the card decodes
batch i while the host assembles batch i + 1.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..losses.criterion import NMTStats, language_model_loss, nmt_loss
from ..models.base import Features
from ..pivot import pivot_translate, post_edit
from ..utils.text import decode_sequence

EVAL_WINDOW = 32   # batches of decoded ids kept on the device before a fetch


def language_eval(dataset_type: str, preds: List[dict], model_id: str,
                  split: str, *, references: Dict[Any, List[str]],
                  eval_results_dir: str = "eval_results",
                  spice: bool = False) -> dict:
    """Score predictions against references; cache the result json.

    `references`: image_id -> list of reference captions (the reference
    loads these from annotation files; callers supply them directly so zh
    (AIC) and en (COCO) routes share one scorer stack).

    `spice=True` adds the SPICE column the reference's coco route computes
    (coco-caption/pycocoevalcap/eval.py:9-40). Our Spice is a documented
    rule-based STAND-IN (eval/metrics/spice.py): the reference jar is
    stripped upstream, so this column is NOT jar-parity and is off by
    default."""
    from .metrics import Bleu, Cider, Meteor, Rouge, Spice

    if dataset_type == "zh":
        # the reference zh pipeline: every caption, reference AND
        # prediction, is segmented (jieba, or its per-character route) with
        # the 。-strip, then PTB-tokenized (lowercase + ASCII-punctuation
        # removal) before scoring
        from ..native import ptb_tokenize
        from ..scripts.prepro_split_tokenize import segment_zh

        def _norm(s: str) -> str:
            s = " ".join(segment_zh(s.strip().replace("。", "")))
            return ptb_tokenize(s)
    else:
        def _norm(s: str) -> str:
            return s

    gts = {}
    res = {}
    for p in preds:
        iid = p["image_id"]
        if iid in references:
            gts[iid] = [_norm(r) for r in references[iid]]
            res[iid] = [_norm(p["caption"])]
    if not gts:
        return {"error": 1}

    overall: Dict[str, float] = {}
    # imgToEval entries carry their image_id (reference artifact schema)
    img_to_eval: Dict[Any, dict] = {i: {"image_id": i} for i in gts}

    bleu_scores, bleu_per = Bleu(4).compute_score(gts, res)
    for k in range(4):
        overall[f"Bleu_{k + 1}"] = bleu_scores[k]
        for i, iid in enumerate(sorted(gts)):
            img_to_eval[iid][f"Bleu_{k + 1}"] = bleu_per[k][i]
    scorers = [("METEOR", Meteor()), ("ROUGE_L", Rouge()),
               ("CIDEr", Cider())]
    if spice:
        scorers.append(("SPICE", Spice()))  # stand-in, not jar parity
    for name, scorer in scorers:
        mean, per = scorer.compute_score(gts, res)
        overall[name] = mean
        for i, iid in enumerate(sorted(gts)):
            img_to_eval[iid][name] = per[i]

    os.makedirs(eval_results_dir, exist_ok=True)
    cache_path = os.path.join(eval_results_dir,
                              f"{dataset_type}_{model_id}_{split}.json")
    with open(cache_path, "w") as f:
        json.dump({"overall": overall, "imgToEval": {str(k): v for k, v in
                                                     img_to_eval.items()}}, f)
    return overall


def _upload(x, device, dtype=None) -> torch.Tensor:
    # numpy from the caption loader, tensors already on the device from
    # the raw-image loader
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    if dtype is not None:
        t = t.to(dtype)
    elif t.is_floating_point():
        t = t.to(torch.float32)
    return t.to(device, non_blocking=True)


@torch.no_grad()
def eval_split(model, loader, *, split: str = "val", num_images: int = -1,
               beam_size: int = 1,
               language_eval_refs: Optional[Dict] = None,
               dataset_type: str = "zh", model_id: str = "model",
               nmt_model=None, nmt_valid=None, verbose: bool = False,
               spice: bool = False,
               eval_results_dir: str = "eval_results") -> dict:
    """Main val loop (parity: eval_utils.eval_split :208-327) on the
    model's device. Greedy decoding at beam_size 1, else the beam's best.

    Returns {'loss', 'predictions', 'lang_stats', 'nmt_stats'}.
    """
    device = model.device
    loader.reset_iterator(split)
    n_total = len(loader.split_ix[split])
    budget = n_total if num_images <= 0 else min(num_images, n_total)

    loss_sum = torch.zeros((), dtype=torch.float32, device=device)
    n_loss = 0
    pending = []
    drain_ptr = 0
    seen = set()
    done = False
    while not done:
        data = loader.get_batch(split)
        feats = Features(
            fc_feats=_upload(data["fc_feats"], device),
            att_feats=_upload(data["att_feats"], device),
            attri_feats=_upload(data["attri_feats"], device),
            att_masks=_upload(data["att_masks"], device))
        # raw-image loaders carry no labels (all-zero masks): skip the XE
        # loss exactly like the reference (eval_utils.py:244-252 gates on
        # data.get('labels'))
        if data["masks"].sum() > 0:
            labels = _upload(data["labels"], device, torch.int64)
            masks = _upload(data["masks"], device)
            out = model.forward(feats, labels, training=False)
            loss_sum = loss_sum + language_model_loss(out, labels[:, 1:],
                                                      masks[:, 1:])
            n_loss += 1

        # one caption per image: take the first of each seq_per_img block
        spi = loader.seq_per_img
        first = torch.arange(0, feats.fc_feats.shape[0], spi, device=device)
        feats1 = Features(*(x[first] if x is not None else None
                            for x in feats))
        if beam_size > 1:
            seq = model.sample_beam(feats1, beam_size=beam_size).seq[:, 0]
        else:
            seq = model.sample(feats1, greedy=True)[0]
        batch_infos = []
        for info in data["infos"]:
            fresh = info["id"] not in seen
            if fresh:
                seen.add(info["id"])
            batch_infos.append(info if fresh else None)
        pending.append((batch_infos, seq))
        while len(pending) - drain_ptr > EVAL_WINDOW:
            infos_d, seq_d = pending[drain_ptr]
            pending[drain_ptr] = (infos_d, seq_d.cpu())
            drain_ptr += 1
        # budget bookkeeping with pop-on-wrap (eval_utils.py:287-300)
        if data["bounds"]["wrapped"] or len(seen) >= budget:
            done = True

    predictions = []
    for batch_infos, seq in pending:
        caps = decode_sequence(loader.vocab.ix_to_word, seq.cpu().numpy())
        for info, cap in zip(batch_infos, caps):
            if info is None:
                continue
            predictions.append({"image_id": info["id"], "caption": cap})
            if verbose:
                print(f"image {info['id']}: {cap}")
    losses = float(loss_sum) if n_loss else 0.0
    predictions = predictions[:budget]

    lang_stats = None
    if language_eval_refs is not None:
        lang_stats = language_eval(dataset_type, predictions, model_id, split,
                                   references=language_eval_refs,
                                   spice=spice,
                                   eval_results_dir=eval_results_dir)

    nmt_stats = None
    if nmt_model is not None and nmt_valid is not None:
        zero = torch.zeros((), dtype=torch.float32, device=nmt_model.device)
        total = NMTStats(zero, zero, zero)
        for _ in range(len(nmt_valid)):
            nb, _ = nmt_valid.next_batch()
            src = _upload(nb["src"], nmt_model.device, torch.int64)
            lengths = _upload(nb["lengths"], nmt_model.device, torch.int64)
            tgt = _upload(nb["tgt"], nmt_model.device, torch.int64)
            outs, _ = nmt_model.forward(src, lengths, tgt)
            total = total + nmt_loss(nmt_model.generator_logits(outs),
                                     tgt[:, 1:])[1]
        nmt_stats = {"valid_ppl": float(total.ppl()),
                     "valid_acc": float(total.accuracy())}

    return {"loss": losses / max(n_loss, 1), "predictions": predictions,
            "lang_stats": lang_stats, "nmt_stats": nmt_stats}


def eval_split_coco_paired(model, loader, **kw) -> dict:
    """Plain single-model COCO eval (parity: eval_utils.py:476-567, the path
    eval_ensemble uses): `eval_split` with dataset_type='coco'."""
    kw.setdefault("dataset_type", "coco")
    return eval_split(model, loader, **kw)


@torch.no_grad()
def eval_split_coco_unpaired(cap_model, nmt_model, coco_loader, cap2nmt,
                             nmt_tgt_itos: Dict[int, str], *,
                             split: str = "val", num_images: int = -1,
                             cap_beam: int = 5, nmt_beam: int = 15,
                             nmt_max_len: int = 100,
                             en_refs: Optional[Dict] = None,
                             zh_refs: Optional[Dict] = None,
                             model_id: str = "pivot", src2tgt=None,
                             replace_unk: bool = True, spice: bool = False,
                             eval_results_dir: str = "eval_results") -> dict:
    """Pivot eval (parity: eval_utils.py:329-473) on the captioner's
    device: decode zh for COCO images and translate zh->en in one
    `pivot_translate` call, then post-edit on the host (`pivot.post_edit`:
    UNK -> the zh word at the attention argmax with `replace_unk`, stop at
    PAD / EOS, skip BOS, expand contractions), keep each image id once, cut
    to the budget, and score en vs `en_refs` (and zh vs `zh_refs`).

    `src2tgt` (the copy attention's source -> target id map) raises: copy
    attention is not ported yet (ROADMAP A11)."""
    if src2tgt is not None:
        raise NotImplementedError("eval_split_coco_unpaired with src2tgt: "
                                  "copy attention is not ported yet "
                                  "(ROADMAP A11)")
    device = cap_model.device
    cap2nmt_t = _upload(cap2nmt, device, torch.int64)
    coco_loader.reset_iterator(split)
    n_total = len(coco_loader.split_ix[split])
    budget = n_total if num_images <= 0 else min(num_images, n_total)

    pending = []
    drain_ptr = 0
    seen = set()
    done = False
    while not done:
        data = coco_loader.get_batch(split)
        first = np.arange(0, data["fc_feats"].shape[0],
                          coco_loader.seq_per_img)
        feats = Features(
            fc_feats=_upload(data["fc_feats"][first], device),
            att_feats=_upload(data["att_feats"][first], device),
            attri_feats=_upload(data["attri_feats"][first], device),
            att_masks=_upload(data["att_masks"][first], device))
        out = pivot_translate(cap_model, nmt_model, feats, cap2nmt_t,
                              cap_beam=cap_beam, nmt_beam=nmt_beam,
                              nmt_max_len=nmt_max_len)
        batch_infos = []
        for info in data["infos"]:
            fresh = info["id"] not in seen
            if fresh:
                seen.add(info["id"])
            batch_infos.append(info if fresh else None)
        pending.append((batch_infos, out))
        while len(pending) - drain_ptr > EVAL_WINDOW:
            infos_d, out_d = pending[drain_ptr]
            pending[drain_ptr] = (infos_d, tuple(x.cpu() for x in out_d))
            drain_ptr += 1
        if data["bounds"]["wrapped"] or len(seen) >= budget:
            done = True

    zh_preds, en_preds = [], []
    for batch_infos, out in pending:
        zh, en, attn = (x.cpu().numpy() for x in out)
        zh_caps, en_caps = post_edit(zh, en, attn,
                                     coco_loader.vocab.ix_to_word,
                                     nmt_tgt_itos, replace_unk=replace_unk)
        for bi, info in enumerate(batch_infos):
            if info is None:
                continue
            zh_preds.append({"image_id": info["id"], "caption": zh_caps[bi]})
            en_preds.append({"image_id": info["id"], "caption": en_caps[bi]})

    out = {"zh_predictions": zh_preds[:budget],
           "en_predictions": en_preds[:budget]}
    if en_refs is not None:
        out["en_lang_stats"] = language_eval(
            "coco", out["en_predictions"], model_id, split,
            references=en_refs, spice=spice,
            eval_results_dir=eval_results_dir)
    if zh_refs is not None:
        out["zh_lang_stats"] = language_eval(
            "zh", out["zh_predictions"], model_id, split,
            references=zh_refs, eval_results_dir=eval_results_dir)
    return out
