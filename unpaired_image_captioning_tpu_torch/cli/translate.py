"""Standalone NMT translate CLI (counterpart of
`unpaired_image_captioning_tpu/cli/translate.py`).

Parity: reference `misc/OpenNMT-py-dalegebit/translate.py` — load an NMT
checkpoint, translate a tokenized source file with beam search, UNK-replace
from attention argmax, write hypotheses (+ optional n-best / scores).

Reads a run directory of the port's training CLI: `nmt_config.json`
(`model_type` and the model's constructor arguments), `model_nmt.pt` and
`{src,tgt}_dict.json`. Runs on the card unless `-device` names another:

    python -m unpaired_image_captioning_tpu_torch.cli.translate \\
        -model run -src zh.txt -output en.txt [-tgt gold.txt] [-device cpu]

`-tgt` adds GOLD AVG SCORE / GOLD PPL. A copy-attention NMT decodes with
`src_dict.align(tgt_dict)`: `-copy_mode extended` (the default) over the
extended vocab, whose ids past the target vocab are exact copies of a
source word; `-copy_mode fold` with the reference Translator's own
scoring, its copies resolved through the attention argmax.
"""

from __future__ import annotations

import argparse
import math
import os

import numpy as np


def load_nmt_run(run: str, device):
    """(model, src dict, tgt dict) of the NMT of run directory `run`, the
    model on `device` with the weights of `model_nmt.pt`."""
    from ..models.base import resolve_device
    from ..models.nmt import NMTModel
    from ..models.nmt_transformer import TransformerNMTModel
    from ..train.checkpoint import load_json, load_state
    from ..vocab import Dict

    device = resolve_device(device)
    nmt_cfg = load_json(os.path.join(run, "nmt_config.json"))
    src_dict = Dict.from_state_dict(load_json(os.path.join(run,
                                                           "src_dict.json")))
    tgt_dict = Dict.from_state_dict(load_json(os.path.join(run,
                                                           "tgt_dict.json")))
    kind = nmt_cfg.pop("model_type", "rnn")
    cls = TransformerNMTModel if kind == "transformer" else NMTModel
    model = cls(**nmt_cfg, device=device)
    model.load_state_dict(load_state(os.path.join(run, "model_nmt.pt"),
                                     device))
    model.eval()
    return model, src_dict, tgt_dict


def main(argv=None):
    import torch

    from .. import constants as C

    p = argparse.ArgumentParser("translate")
    p.add_argument("-model", required=True,
                   help="run dir with model_nmt.pt + nmt_config.json + dicts")
    p.add_argument("-src", required=True)
    p.add_argument("-tgt", default=None,
                   help="gold target file: report GOLD AVG SCORE / GOLD PPL "
                   "(fork translate.py -tgt + reportScore:74-77)")
    p.add_argument("-output", default="pred.txt")
    p.add_argument("-beam_size", type=int, default=15)
    p.add_argument("-max_sent_length", type=int, default=100)
    p.add_argument("-batch_size", type=int, default=30)
    p.add_argument("-n_best", type=int, default=1)
    p.add_argument("-replace_unk", action="store_true", default=True)
    p.add_argument("-copy_mode", choices=("extended", "fold"),
                   default="extended",
                   help="copy-attention beam scoring: 'extended' decodes "
                   "over the extended dynamic vocab (exact source copies); "
                   "'fold' reproduces the reference Translator's own "
                   "decode-time scoring (copy mass folded onto align-mapped "
                   "ids, onmt/Translator.py:207-226)")
    p.add_argument("-device", default="cuda",
                   help="torch device of the model (default: the card)")
    args = p.parse_args(argv)

    model, src_dict, tgt_dict = load_nmt_run(args.model, args.device)
    device = model.device

    def up(a):
        return torch.as_tensor(a, dtype=torch.int64, device=device)

    with open(args.src, encoding="utf-8") as f:
        lines = [l.split() for l in f]
    tgt_lines = None
    if args.tgt:
        with open(args.tgt, encoding="utf-8") as f:
            tgt_lines = [l.split() for l in f]
        assert len(tgt_lines) == len(lines), "-src/-tgt line count mismatch"
    max_len = max(max((len(l) for l in lines), default=1), 1)
    src2tgt = (src_dict.align(tgt_dict)
               if getattr(model, "copy_attn", False) else None)
    copy_kw = ({} if src2tgt is None
               else {"src2tgt": src2tgt, "copy_mode": args.copy_mode})
    out_lines = []
    pred_score_total = pred_words_total = 0.0
    gold_score_total = gold_words_total = 0.0
    for i in range(0, len(lines), args.batch_size):
        chunk = lines[i: i + args.batch_size]
        src = np.zeros((len(chunk), max_len), np.int64)
        for bi, toks in enumerate(chunk):
            ids = src_dict.convert_to_idx(toks, C.UNK_WORD)
            src[bi, :len(ids)] = ids
        # empty source lines (possible in pipeline use) still need a valid
        # length-1 window for the masked encoder
        lengths = np.maximum((src != C.PAD).sum(1), 1)
        with torch.inference_mode():
            res = model.translate_batch(up(src), up(lengths),
                                        beam_size=args.beam_size,
                                        max_len=args.max_sent_length,
                                        **copy_kw)
            seq, copy_pos = res.seq, None
            if src2tgt is not None and args.copy_mode == "extended":
                # extended dynamic vocab: ids >= V are exact source copies
                seq, copy_pos = model.resolve_extended(seq)
                copy_pos = copy_pos.cpu().numpy()
            seqs = seq.cpu().numpy()
            attn = res.aux.cpu().numpy()
            scores = res.scores.cpu().numpy()
            if tgt_lines is not None:
                # gold log-likelihoods (fork translate.py -tgt)
                gchunk = tgt_lines[i: i + args.batch_size]
                gt = max(max((len(t) for t in gchunk), default=0), 1) + 2
                tgt = np.zeros((len(gchunk), gt), np.int64)
                for bi, toks in enumerate(gchunk):
                    ids = tgt_dict.convert_to_idx(toks, C.UNK_WORD,
                                                  bos_word=C.BOS_WORD,
                                                  eos_word=C.EOS_WORD)
                    tgt[bi, :len(ids)] = ids
                gscores = model.gold_scores(up(src), up(lengths), up(tgt))
                gold_score_total += float(gscores.sum())
                gold_words_total += sum(len(t) for t in gchunk)
        for bi, toks in enumerate(chunk):
            for k in range(args.n_best):
                words = []
                for t, tok in enumerate(seqs[bi, k]):
                    tok = int(tok)
                    if tok in (C.PAD, C.EOS):
                        break
                    if tok == C.BOS:
                        continue
                    if tok == C.UNK and args.replace_unk and toks:
                        # the exact copy's position where the extended
                        # vocab gives one, else the source token with the
                        # most attention (NMT_Models.buildTargetTokens
                        # :312-320)
                        if copy_pos is not None and copy_pos[bi, k, t] >= 0:
                            j = min(int(copy_pos[bi, k, t]), len(toks) - 1)
                        else:
                            j = min(int(attn[bi, k, t]), len(toks) - 1)
                        words.append(toks[j])
                    else:
                        words.append(tgt_dict.get_label(tok, C.UNK_WORD))
                if k == 0:
                    out_lines.append(" ".join(words))
                    pred_score_total += float(scores[bi, 0])
                    pred_words_total += len(words)
    with open(args.output, "w", encoding="utf-8") as f:
        f.write("\n".join(out_lines) + "\n")
    # reportScore (fork translate.py:74-77)
    if pred_words_total:
        print("PRED AVG SCORE: %.4f, PRED PPL: %.4f" % (
            pred_score_total / pred_words_total,
            math.exp(-pred_score_total / pred_words_total)))
    if tgt_lines is not None and gold_words_total:
        print("GOLD AVG SCORE: %.4f, GOLD PPL: %.4f" % (
            gold_score_total / gold_words_total,
            math.exp(-gold_score_total / gold_words_total)))
    print(f"translated {len(out_lines)} sentences -> {args.output}")


if __name__ == "__main__":
    main()
