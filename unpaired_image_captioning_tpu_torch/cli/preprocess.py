"""NMT corpus preprocessing CLI (the port's copy of
`unpaired_image_captioning_tpu/cli/preprocess.py`):

    python -m unpaired_image_captioning_tpu_torch.cli.preprocess \
        -train_src train.zh -train_tgt train.en -valid_src valid.zh \
        -valid_tgt valid.en -save_data data/nmt -src_vocab_size 50000

Parity: reference `scripts/prepro_aic_nmt.py` + vendored OpenNMT
`preprocess.py` — build src/tgt Dicts with frequency pruning, length
filtering, encode with BOS/EOS on the target side, `-shuffle` then
sort-by-src-length (prepro_aic_nmt.py:276-296), optional BPE
(the vendored subword-nmt role, utils/bpe.py), existing-dict reuse
(`initVocabulary`'s vocabFile path, prepro_aic_nmt.py:118-128), and a
dict-coverage report (non-UNK token rate per side). PAD=0/UNK=1/BOS=2/EOS=3
(onmt.Constants).

Writes `<save_data>.train.npz` / `.valid.npz` (`src`, `tgt` int32, and the
`src_feat_{j}` / `tgt_feat_{j}` streams of a `word￨feat` corpus) where the
JAX package writes `.h5`: the port's loaders read either, and the `.npz`
needs no `h5py`. The dicts go to `<save_data>.src_dict.json` and
`.tgt_dict.json` (and `.{src,tgt}_feature_{j}.dict.json`), as in JAX;
`cli.train --input_nmt_dict` reads one JSON with `src` and `tgt` keys,
which a user joins from the two.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def build_dict(path: str, size: int, lower: bool = False, vocab_file: str = ""):
    from ..vocab import Dict, extract_features, make_nmt_dict

    if vocab_file:
        with open(vocab_file, encoding="utf-8") as f:
            d = Dict.from_state_dict(json.load(f))
        print(f"loaded dict from {vocab_file}: {d.size()} entries")
        return d
    d = make_nmt_dict(lower=lower)
    with open(path, encoding="utf-8") as f:
        for line in f:
            # word￨feat tokens contribute only their word part here
            # (onmt fork preprocess.py makeVocabulary :73-103)
            words, _, _ = extract_features(line.split())
            for w in words:
                d.add(w)
    orig = d.size()
    d = d.prune(size)
    print(f"built dict from {path}: {orig} -> {d.size()} entries")
    return d


def build_feature_dicts(path: str, lower: bool = False):
    """Per-column feature Dicts for a `word￨feat1￨feat2...` corpus
    (onmt fork preprocess.py:77-103 — one Dict per column, the 4 specials
    pre-registered, never pruned). Returns [] when the corpus carries no
    features."""
    from ..vocab import extract_features, make_nmt_dict

    dicts = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            _, features, n = extract_features(line.split())
            if n == 0:
                continue
            if not dicts:
                dicts = [make_nmt_dict(lower=lower) for _ in range(n)]
            assert len(dicts) == n, \
                "all sentences must have the same number of features"
            for j, col in enumerate(features):
                for w in col:
                    dicts[j].add(w)
    return dicts


def encode_corpus(src_path, tgt_path, src_dict, tgt_dict, *, src_seq_length,
                  tgt_seq_length, shuffle=0, seed=3435, src_bpe=None,
                  tgt_bpe=None, report_name="", src_feature_dicts=(),
                  tgt_feature_dicts=()):
    from .. import constants as C
    from ..vocab import extract_features

    if src_feature_dicts or tgt_feature_dicts:
        # BPE resegmentation would desync word↔feature alignment
        assert src_bpe is None and tgt_bpe is None, \
            "word features (￨) and BPE are mutually exclusive"
    srcs, tgts = [], []
    src_feats = [[] for _ in src_feature_dicts]
    tgt_feats = [[] for _ in tgt_feature_dicts]
    kept = dropped = 0
    with open(src_path, encoding="utf-8") as fs, \
            open(tgt_path, encoding="utf-8") as ft:
        for sline, tline in zip(fs, ft):
            if src_bpe is not None:
                sline = src_bpe.segment(sline)
            if tgt_bpe is not None:
                tline = tgt_bpe.segment(tline)
            # onmt fork IO.py readSrcLine/readTgtLine (:24-65): strip the
            # ￨-features off every token; encode feature columns with their
            # own dicts (UNK only — no BOS/EOS even on the target side)
            s, sfeat, _ = extract_features(sline.split())
            t, tfeat, _ = extract_features(tline.split())
            if (not s or not t or len(s) > src_seq_length
                    or len(t) > tgt_seq_length):
                dropped += 1
                continue
            srcs.append(src_dict.convert_to_idx(s, C.UNK_WORD))
            tgts.append(tgt_dict.convert_to_idx(t, C.UNK_WORD,
                                                bos_word=C.BOS_WORD,
                                                eos_word=C.EOS_WORD))
            for j, fd in enumerate(src_feature_dicts):
                src_feats[j].append(fd.convert_to_idx(sfeat[j], C.UNK_WORD))
            for j, fd in enumerate(tgt_feature_dicts):
                tgt_feats[j].append(fd.convert_to_idx(tfeat[j], C.UNK_WORD))
            kept += 1
    print(f"kept {kept}, dropped {dropped} (length filter)")

    # -shuffle then stable sort by src length (prepro_aic_nmt.py:276-296 —
    # the shuffle decides the order WITHIN each length bucket, which is what
    # the bucketed batcher then consumes)
    def reorder(perm):
        nonlocal srcs, tgts, src_feats, tgt_feats
        srcs = [srcs[i] for i in perm]
        tgts = [tgts[i] for i in perm]
        src_feats = [[col[i] for i in perm] for col in src_feats]
        tgt_feats = [[col[i] for i in perm] for col in tgt_feats]

    if shuffle:
        rng = np.random.RandomState(seed)
        reorder(rng.permutation(kept))
    reorder(np.argsort([len(s) for s in srcs], kind="stable"))

    # dict-coverage report: fraction of corpus tokens that map to a real
    # dict entry (not UNK) — the number that predicts UNK-replacement load
    # at translate time
    def coverage(rows, skip_specials):
        total = unk = 0
        for r in rows:
            for tok in r:
                if skip_specials and tok in (C.PAD, C.BOS, C.EOS):
                    continue
                total += 1
                unk += int(tok == C.UNK)
        return 100.0 * (1 - unk / max(total, 1))

    if report_name:
        print(f"{report_name} dict coverage: "
              f"src {coverage(srcs, False):.2f}% / "
              f"tgt {coverage(tgts, True):.2f}% non-UNK tokens")

    def pad(rows, width):
        out = np.zeros((kept, width), np.int32)
        for i, r in enumerate(rows):
            out[i, :len(r)] = r
        return out

    src = pad(srcs, max(len(x) for x in srcs))
    tgt = pad(tgts, max(len(x) for x in tgts))
    if not (src_feature_dicts or tgt_feature_dicts):
        return src, tgt
    sf = [pad(col, src.shape[1]) for col in src_feats]
    tf = [pad(col, tgt.shape[1]) for col in tgt_feats]
    return src, tgt, sf, tf


def _maybe_bpe(corpus_path, merges, codes_path, save_codes_path):
    """Load or learn BPE codes; returns a BPE segmenter or None."""
    from ..utils.bpe import BPE, learn_bpe, load_codes, save_codes

    if codes_path:
        return BPE(load_codes(codes_path))
    if merges > 0:
        with open(corpus_path, encoding="utf-8") as f:
            codes = learn_bpe(f, num_merges=merges)
        if save_codes_path:
            save_codes(codes, save_codes_path)
            print(f"learned {len(codes)} BPE merges -> {save_codes_path}")
        return BPE(codes)
    return None


def main(argv=None):
    from ..data.arrays import write_arrays

    p = argparse.ArgumentParser("preprocess")
    p.add_argument("-train_src", required=True)
    p.add_argument("-train_tgt", required=True)
    p.add_argument("-valid_src")
    p.add_argument("-valid_tgt")
    p.add_argument("-save_data", required=True)
    p.add_argument("-src_vocab_size", type=int, default=50000)
    p.add_argument("-tgt_vocab_size", type=int, default=50000)
    p.add_argument("-src_seq_length", type=int, default=50)
    p.add_argument("-tgt_seq_length", type=int, default=50)
    p.add_argument("-src_vocab", default="",
                   help="existing src dict json to reuse instead of building")
    p.add_argument("-tgt_vocab", default="")
    p.add_argument("-shuffle", type=int, default=1,
                   help="shuffle before the length sort (prepro_aic_nmt.py:71)")
    p.add_argument("-seed", type=int, default=3435)
    p.add_argument("-src_bpe_merges", type=int, default=0,
                   help="learn N BPE merges on the src corpus and apply")
    p.add_argument("-tgt_bpe_merges", type=int, default=0)
    p.add_argument("-src_bpe_codes", default="",
                   help="existing subword-nmt codes file to apply to src")
    p.add_argument("-tgt_bpe_codes", default="")
    p.add_argument("-lower", action="store_true")
    args = p.parse_args(argv)

    os.makedirs(os.path.dirname(args.save_data) or ".", exist_ok=True)
    src_bpe = _maybe_bpe(args.train_src, args.src_bpe_merges,
                         args.src_bpe_codes, args.save_data + ".src_bpe.codes")
    tgt_bpe = _maybe_bpe(args.train_tgt, args.tgt_bpe_merges,
                         args.tgt_bpe_codes, args.save_data + ".tgt_bpe.codes")

    def dict_corpus(path, bpe, vocab_file):
        """Dict built over the BPE-segmented stream when BPE is active.
        Skipped entirely when an existing vocab file is supplied —
        build_dict loads it without reading the corpus, so segmenting the
        full training set here would be pure wasted I/O."""
        if bpe is None or vocab_file:
            return path
        seg_path = args.save_data + ".tmp_seg.txt"
        with open(path, encoding="utf-8") as f, \
                open(seg_path, "w", encoding="utf-8") as out:
            for line in f:
                out.write(bpe.segment(line) + "\n")
        return seg_path

    src_dict = build_dict(dict_corpus(args.train_src, src_bpe, args.src_vocab),
                          args.src_vocab_size, args.lower, args.src_vocab)
    tgt_dict = build_dict(dict_corpus(args.train_tgt, tgt_bpe, args.tgt_vocab),
                          args.tgt_vocab_size, args.lower, args.tgt_vocab)
    tmp_seg = args.save_data + ".tmp_seg.txt"
    if os.path.exists(tmp_seg):
        os.remove(tmp_seg)

    # word￨feature corpora (onmt fork IO.py:67-91): per-column feature
    # dicts + encoded feature streams ride along when present
    src_fdicts = [] if src_bpe else build_feature_dicts(args.train_src,
                                                        args.lower)
    tgt_fdicts = [] if tgt_bpe else build_feature_dicts(args.train_tgt,
                                                        args.lower)
    if src_fdicts or tgt_fdicts:
        print(f"word features: src {len(src_fdicts)} / "
              f"tgt {len(tgt_fdicts)} columns")

    def write(path, enc):
        arrays = {"src": enc[0], "tgt": enc[1]}
        if len(enc) == 4:
            for j, a in enumerate(enc[2]):
                arrays[f"src_feat_{j}"] = a
            for j, a in enumerate(enc[3]):
                arrays[f"tgt_feat_{j}"] = a
        write_arrays(path, arrays)

    enc = encode_corpus(args.train_src, args.train_tgt, src_dict,
                        tgt_dict, src_seq_length=args.src_seq_length,
                        tgt_seq_length=args.tgt_seq_length,
                        shuffle=args.shuffle, seed=args.seed,
                        src_bpe=src_bpe, tgt_bpe=tgt_bpe,
                        report_name="train",
                        src_feature_dicts=src_fdicts,
                        tgt_feature_dicts=tgt_fdicts)
    write(args.save_data + ".train.npz", enc)
    if args.valid_src and args.valid_tgt:
        venc = encode_corpus(args.valid_src, args.valid_tgt, src_dict,
                             tgt_dict,
                             src_seq_length=args.src_seq_length,
                             tgt_seq_length=args.tgt_seq_length,
                             src_bpe=src_bpe, tgt_bpe=tgt_bpe,
                             report_name="valid",
                             src_feature_dicts=src_fdicts,
                             tgt_feature_dicts=tgt_fdicts)
        write(args.save_data + ".valid.npz", venc)
    with open(args.save_data + ".src_dict.json", "w") as f:
        json.dump(src_dict.state_dict(), f)
    with open(args.save_data + ".tgt_dict.json", "w") as f:
        json.dump(tgt_dict.state_dict(), f)
    for name, fdicts in (("src", src_fdicts), ("tgt", tgt_fdicts)):
        for j, fd in enumerate(fdicts):
            with open(f"{args.save_data}.{name}_feature_{j}.dict.json",
                      "w") as f:
                json.dump(fd.state_dict(), f)
    print("wrote", args.save_data + ".{train,valid}.npz + dicts")


if __name__ == "__main__":
    main()
