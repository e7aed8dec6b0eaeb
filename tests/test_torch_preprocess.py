"""The port's preprocessing surface (`cli/preprocess.py`,
`scripts/prepro_split_tokenize.py`, `prepro_labels.py`,
`prepro_reference_json.py`, `prepro_json2text.py`, `make_bu_data.py`,
`prepro_backtranslate.py`, `vocab.extract_features`,
`data/arrays.write_arrays`) against the JAX package's on the CPU.

The same seeded inputs go through both. The JAX side writes `.h5` (through
this machine's `h5py`), the port `.npz`: every array is equal exactly,
dtypes included, every JSON and codes file is equal, and so are the
printed dict, `kept/dropped` and coverage lines. The port's HDF5 route
(`prepro_labels --output_h5 label.h5`) is held to JAX's file once.
"""

import base64
import csv
import dataclasses
import json
import os
import random
import sys

import numpy as np
import pytest
import torch

from unpaired_image_captioning_tpu_torch import constants as C
from unpaired_image_captioning_tpu_torch.data.arrays import (read_arrays,
                                                             write_arrays)

torch.set_num_threads(1)

ZH_POOL = [chr(0x4E00 + i) for i in range(40)]
EN_POOL = ["".join(w) for w in ("ab", "abc", "abd", "bcd", "cde", "abcde",
                                "dab", "eab", "ce", "bad", "cab", "deed",
                                "bead", "acce", "ebb", "dace")]
POS = ["DT", "NN", "VBD", "IN"]


def _corpus(path, n, seed, featured=False):
    """n zh-en line pairs (zh: characters from ZH_POOL with a skewed
    frequency, one word a line up to 14; en: words of EN_POOL), a few too
    long for the length filter and one empty pair."""
    rs = np.random.RandomState(seed)
    p = 1.0 / np.arange(1, len(ZH_POOL) + 1)
    p /= p.sum()
    src, tgt = [], []
    for i in range(n):
        k = 0 if i == 3 else rs.randint(1, 15)
        words = [ZH_POOL[j] for j in rs.choice(len(ZH_POOL), k, p=p)]
        if featured:
            words = [f"{w}￨{POS[rs.randint(4)]}" for w in words]
        src.append(" ".join(words))
        tgt.append(" ".join(EN_POOL[j] for j in rs.randint(
            0, len(EN_POOL), 0 if i == 3 else rs.randint(1, 12))))
    files = {}
    for side, lines in (("src", src), ("tgt", tgt)):
        files[side] = str(path) + f".{side}"
        with open(files[side], "w", encoding="utf-8") as f:
            f.write("\n".join(lines) + "\n")
    return files


def _same_arrays(port_path, jax_path):
    import h5py

    got = read_arrays(port_path)
    with h5py.File(jax_path, "r") as f:
        want = {k: f[k][...] for k in f.keys()}
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _same_outputs(port_dir, jax_dir):
    """Every file JAX wrote has its twin from the port: `.h5` as `.npz`
    with equal arrays, JSON equal, anything else byte-equal."""
    names = sorted(os.listdir(jax_dir))
    assert sorted(n.replace(".h5", ".npz") for n in names) == sorted(
        os.listdir(port_dir))
    for n in names:
        jp = os.path.join(jax_dir, n)
        if n.endswith(".h5"):
            _same_arrays(os.path.join(port_dir, n[:-3] + ".npz"), jp)
        elif n.endswith(".json"):
            with open(jp, encoding="utf-8") as a, open(
                    os.path.join(port_dir, n), encoding="utf-8") as b:
                assert json.load(b) == json.load(a), n
        else:
            with open(jp, "rb") as a, open(os.path.join(port_dir, n),
                                           "rb") as b:
                assert b.read() == a.read(), n
    return names


def _run_both(tmp_path, capsys, jax_main, port_main, make_argv):
    """jax_main(make_argv(jax dir)) and port_main(make_argv(port dir));
    returns the two dirs and the printed lines, each dir's path and `.h5`
    written as the port's."""
    out = {}
    for pkg, main in (("jax", jax_main), ("port", port_main)):
        d = tmp_path / pkg
        d.mkdir()
        capsys.readouterr()
        main(make_argv(str(d)))
        out[pkg] = capsys.readouterr().out.replace(str(d), "DIR")
    return (str(tmp_path / "port"), str(tmp_path / "jax"),
            out["port"], out["jax"].replace(".h5", ".npz"))


PREPROCESS_CASES = {
    "shuffle": ["-src_vocab_size", "20", "-tgt_vocab_size", "12",
                "-src_seq_length", "11", "-tgt_seq_length", "9",
                "-shuffle", "1", "-seed", "7"],
    "vocab_reuse": ["-src_vocab", "{vocab}", "-shuffle", "0"],
    "bpe_learned": ["-src_bpe_merges", "25", "-tgt_bpe_merges", "10",
                    "-src_seq_length", "40", "-tgt_seq_length", "40"],
    "bpe_codes": ["-src_bpe_codes", "{codes}", "-tgt_bpe_codes", "{codes}",
                  "-tgt_vocab_size", "15"],
    "features": ["-shuffle", "1", "-seed", "3"],
}


@pytest.mark.parametrize("case", sorted(PREPROCESS_CASES))
def test_preprocess_matches_jax(case, tmp_path, capsys):
    from unpaired_image_captioning_tpu.cli import preprocess as jpre
    from unpaired_image_captioning_tpu.utils.bpe import learn_bpe, save_codes

    from unpaired_image_captioning_tpu_torch.cli import preprocess
    from unpaired_image_captioning_tpu_torch.vocab import Dict

    featured = case == "features"
    train = _corpus(tmp_path / "train", 60, 0, featured)
    valid = _corpus(tmp_path / "valid", 12, 1, featured)
    extra = {}
    if case == "vocab_reuse":
        # an existing dict: specials, then a few pool words and one
        # word the corpus lacks
        extra["vocab"] = str(tmp_path / "vocab.json")
        d = Dict([C.PAD_WORD, C.UNK_WORD, C.BOS_WORD, C.EOS_WORD]
                 + ZH_POOL[5:17] + ["外"])
        with open(extra["vocab"], "w") as f:
            json.dump(d.state_dict(), f)
    if case == "bpe_codes":
        extra["codes"] = str(tmp_path / "en.codes")
        with open(train["tgt"], encoding="utf-8") as f:
            save_codes(learn_bpe(f, num_merges=12), extra["codes"])
    args = [a.format(**extra) for a in PREPROCESS_CASES[case]]

    def argv(d):
        return ["-train_src", train["src"], "-train_tgt", train["tgt"],
                "-valid_src", valid["src"], "-valid_tgt", valid["tgt"],
                "-save_data", os.path.join(d, "nmt")] + args

    port_dir, jax_dir, got, want = _run_both(tmp_path, capsys, jpre.main,
                                             preprocess.main, argv)
    assert got == want
    assert "kept " in got and "dict coverage" in got
    names = _same_outputs(port_dir, jax_dir)
    assert {"nmt.train.h5", "nmt.valid.h5", "nmt.src_dict.json",
            "nmt.tgt_dict.json"} <= set(names)
    if case.startswith("bpe"):
        # the segmented targets: BOS, subwords with their @@ marks, EOS
        with open(os.path.join(port_dir, "nmt.tgt_dict.json")) as f:
            tgt_words = json.load(f)["idx_to_label"].values()
        assert any(w.endswith("@@") for w in tgt_words)
    if case == "bpe_learned":
        assert {"nmt.src_bpe.codes", "nmt.tgt_bpe.codes"} <= set(names)
    if case == "features":
        assert "word features: src 1 / tgt 0 columns" in got
        arrays = read_arrays(os.path.join(port_dir, "nmt.train.npz"))
        assert arrays["src_feat_0"].dtype == np.int32
        assert ((arrays["src_feat_0"] > 0) == (arrays["src"] > 0)).all()
    if case == "shuffle":
        # the shuffle decides the order within each source length
        src = read_arrays(os.path.join(port_dir, "nmt.train.npz"))["src"]
        assert (np.diff((src > 0).sum(1)) >= 0).all()
        assert (src == C.UNK).any()


def test_extract_features_matches_jax():
    from unpaired_image_captioning_tpu.vocab import (
        extract_features as jextract)

    from unpaired_image_captioning_tpu_torch.vocab import extract_features

    for toks in (["the￨DT", "cat￨NN", "￨X", "sat￨VBD"], ["plain", "tokens"],
                 ["a￨1￨x", "b￨2￨y"], []):
        assert extract_features(toks) == jextract(toks)
    with pytest.raises(AssertionError, match="same number of features"):
        extract_features(["a￨1", "b"])


def _annotations(path, n_images, seed):
    """AIC-style annotations: 3 zh captions an image, words of ZH_POOL, an
    ASCII word now and then and a rare character an image (UNK)."""
    rs = np.random.RandomState(seed)
    anns = []
    for i in range(n_images):
        caps = []
        for k in range(3):
            chars = [ZH_POOL[j] for j in rs.randint(0, 25, rs.randint(3, 9))]
            if rs.rand() < 0.3:
                chars.insert(1, " cat ")
            if k == 0:
                chars.append(chr(0x5000 + i))
            caps.append("".join(chars))
        anns.append({"image_id": f"im{i}.jpg", "caption": caps})
    with open(path, "w", encoding="utf-8") as f:
        json.dump(anns, f, ensure_ascii=False)
    return str(path)


@pytest.mark.parametrize("jieba", ["if_installed", "absent"])
def test_caption_pipeline_matches_jax(jieba, tmp_path, capsys, monkeypatch):
    """prepro_split_tokenize -> prepro_labels -> prepro_reference_json:
    the port's outputs equal JAX's, the port's reference JSON read from
    the port's own `.npz` labels, and the port's `.h5` labels equal to
    JAX's file; with jieba where this machine has it, and on the
    per-character route of a machine without it (the card's)."""
    if jieba == "absent":
        monkeypatch.setitem(sys.modules, "jieba", None)
    from unpaired_image_captioning_tpu.scripts import (
        prepro_labels as jlabels)
    from unpaired_image_captioning_tpu.scripts import (
        prepro_reference_json as jref)
    from unpaired_image_captioning_tpu.scripts import (
        prepro_split_tokenize as jsplit)

    from unpaired_image_captioning_tpu_torch.scripts import (
        prepro_labels, prepro_reference_json, prepro_split_tokenize)

    inputs = [_annotations(tmp_path / "a.json", 14, 0),
              _annotations(tmp_path / "b.json", 9, 1)]

    def pipeline(split, labels, ref, d, suffix):
        raw, talk = os.path.join(d, "raw.json"), os.path.join(d, "talk.json")
        label = os.path.join(d, "label" + suffix)
        split(["--inputs", *inputs, "--output", raw, "--num_val", "5",
               "--num_test", "4", "--seed", "11"])
        labels(["--input_json", raw, "--output_json", talk, "--output_h5",
                label, "--max_length", "6", "--word_count_threshold", "2"])
        for s in ("val", "test"):
            ref(["--input_json", talk, "--input_label_h5", label,
                 "--output", os.path.join(d, f"{s}_refs.json"),
                 "--split", s])

    port_dir, jax_dir, got, want = _run_both(
        tmp_path, capsys,
        lambda d: pipeline(jsplit.main, jlabels.main, jref.main, d, ".h5"),
        lambda d: pipeline(prepro_split_tokenize.main, prepro_labels.main,
                           prepro_reference_json.main, d, ".npz"),
        lambda d: d)
    assert got == want
    assert "vocab size" in got
    _same_outputs(port_dir, jax_dir)
    arrays = read_arrays(os.path.join(port_dir, "label.npz"))
    assert arrays["labels"].dtype == np.int32
    assert arrays["label_start_ix"].dtype == np.int64
    # the UNK slot is last and the ASCII word stayed whole
    talk = json.load(open(os.path.join(port_dir, "talk.json"),
                          encoding="utf-8"))
    assert talk["ix_to_word"][str(len(talk["ix_to_word"]))] == C.ZH_UNK_WORD
    assert "cat" in talk["ix_to_word"].values()
    refs = json.load(open(os.path.join(port_dir, "val_refs.json"),
                          encoding="utf-8"))
    assert len(refs["images"]) == 5 and len(refs["annotations"]) == 15

    # the port's HDF5 route: prepro_labels with an .h5 output
    prepro_labels.main(["--input_json", os.path.join(port_dir, "raw.json"),
                        "--output_json", str(tmp_path / "talk_h5.json"),
                        "--output_h5", str(tmp_path / "label.h5"),
                        "--max_length", "6", "--word_count_threshold", "2"])
    _same_arrays(str(tmp_path / "label.h5"),
                 os.path.join(jax_dir, "label.h5"))


def test_split_tokenize_keeps_the_global_generator(tmp_path):
    """The port shuffles with a generator of its own: the module-level
    `random` stream is untouched, and the order is the one
    `random.seed(seed); random.shuffle` gives."""
    from unpaired_image_captioning_tpu_torch.scripts import (
        prepro_split_tokenize)

    inp = _annotations(tmp_path / "a.json", 12, 2)
    random.seed(5)
    before = random.getstate()
    prepro_split_tokenize.main(["--inputs", inp, "--output",
                                str(tmp_path / "raw.json"), "--num_val", "2",
                                "--num_test", "2", "--seed", "9"])
    assert random.getstate() == before
    anns = json.load(open(inp, encoding="utf-8"))
    random.seed(9)
    random.shuffle(anns)
    out = json.load(open(tmp_path / "raw.json", encoding="utf-8"))
    assert [o["file_path"] for o in out] == [a["image_id"] for a in anns]


def test_write_arrays_without_h5py_names_the_npz_route(tmp_path,
                                                       monkeypatch):
    arrays = {"src": np.arange(6, dtype=np.int32).reshape(2, 3)}
    write_arrays(str(tmp_path / "a.npz"), arrays)
    monkeypatch.setitem(sys.modules, "h5py", None)
    write_arrays(str(tmp_path / "b.npz"), arrays)
    for name in ("a.npz", "b.npz"):
        got = read_arrays(str(tmp_path / name))["src"]
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, arrays["src"])
    with pytest.raises(ImportError, match=r"writing .*\.npz"):
        write_arrays(str(tmp_path / "c.h5"), arrays)


def _tsv(path, rows):
    with open(path, "w", newline="") as f:
        w = csv.writer(f, delimiter="\t")
        for iid, boxes, feats in rows:
            w.writerow([iid, "640", "480", str(len(boxes)),
                        base64.b64encode(boxes.tobytes()).decode(),
                        base64.b64encode(feats.tobytes()).decode()])
    return str(path)


def test_make_bu_data_matches_jax(tmp_path, capsys):
    from unpaired_image_captioning_tpu.scripts import make_bu_data as jbu

    from unpaired_image_captioning_tpu_torch.scripts import make_bu_data

    rs = np.random.RandomState(0)
    tsvs = [_tsv(tmp_path / f"bu{t}.tsv",
                 [(str(10 * t + i),
                   np.abs(rs.randn(k, 4)).astype(np.float32),
                   rs.randn(k, 8).astype(np.float32))
                  for i, k in enumerate((3, 5))]) for t in range(2)]
    out = {}
    for pkg, main in (("jax", jbu.main), ("port", make_bu_data.main)):
        main(["--input_tsvs", *tsvs, "--output_dir",
              str(tmp_path / pkg / "bu"), "--feat_dim", "8"])
        out[pkg] = capsys.readouterr().out
    assert out["port"] == out["jax"] == "converted 4 images\n"
    for sub in ("bu_fc", "bu_att", "bu_box"):
        names = sorted(os.listdir(tmp_path / "jax" / sub))
        assert names == sorted(os.listdir(tmp_path / "port" / sub))
        assert len(names) == 4
        for n in names:
            got, want = (np.load(tmp_path / pkg / sub / n)
                         for pkg in ("port", "jax"))
            if n.endswith(".npz"):
                assert got.files == want.files == ["feat"]
                got, want = got["feat"], want["feat"]
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["json2text", "text2json", "text2textid"])
def test_prepro_json2text_matches_jax(mode, tmp_path, capsys):
    from unpaired_image_captioning_tpu.scripts import (
        prepro_json2text as jj2t)

    from unpaired_image_captioning_tpu_torch.scripts import prepro_json2text

    src = tmp_path / "in"
    if mode == "json2text":
        src.write_text(json.dumps([{"image_id": i, "caption": f"a cat {i}"}
                                   for i in (4, 2, 9)]))
    else:
        src.write_text("a cat sits\n\na dog's bone\n")
    (tmp_path / "ids").write_text("4\n2\n9\n")
    _, _, got, want = _run_both(
        tmp_path, capsys, jj2t.main, prepro_json2text.main,
        lambda d: ["--mode", mode, "--input", str(src), "--output",
                   os.path.join(d, "out"), "--ids", str(tmp_path / "ids")])
    assert got == want
    a = (tmp_path / "port" / "out").read_bytes()
    assert a == (tmp_path / "jax" / "out").read_bytes() and a


def _nmt_runs(tmp):
    """One NMT run dir per package from the same parameters (a tiny BiLSTM
    NMT with standard normal weights, UNK and EOS raised, so that the
    translations hold UNK and differ in length)."""
    import jax

    from unpaired_image_captioning_tpu.config import Config
    from unpaired_image_captioning_tpu.models.nmt import NMTModel as JNMT
    from unpaired_image_captioning_tpu.train.checkpoint import save_pytree

    from unpaired_image_captioning_tpu_torch import bridge
    from unpaired_image_captioning_tpu_torch.config import Config as TConfig
    from unpaired_image_captioning_tpu_torch.models.nmt import NMTModel
    from unpaired_image_captioning_tpu_torch.train.checkpoint import (
        CheckpointManager, save_json)
    from unpaired_image_captioning_tpu_torch.vocab import Dict

    cfg = dict(vocab_size=0, rnn_size=16, nmt_src_vocab_size=24,
               nmt_tgt_vocab_size=20, word_vec_size=12, layers=1,
               dropout=0.0)
    jn = JNMT.from_config(Config(**cfg))
    rs = np.random.RandomState(1)
    params = jax.tree_util.tree_map(
        lambda x: rs.randn(*x.shape).astype(np.float32),
        jn.init_params(jax.random.PRNGKey(1)))
    params["generator"]["b"][C.EOS] += 2.0
    params["generator"]["b"][C.UNK] += 2.0
    specials = [C.PAD_WORD, C.UNK_WORD, C.BOS_WORD, C.EOS_WORD]
    dicts = {"src": Dict(specials + [f"w{i}" for i in range(20)]),
             "tgt": Dict(specials + [f"t{i}" for i in range(16)])}
    tn = NMTModel.from_config(TConfig(**cfg), device="cpu")
    runs = {"jax": str(tmp / "jax_run"), "port": str(tmp / "port_run")}
    os.makedirs(runs["jax"])
    save_pytree(os.path.join(runs["jax"], "model_nmt.msgpack"), params)
    CheckpointManager(runs["port"]).save(
        nmt_state=bridge.params_from_jax(params))
    for pkg, nmt_cfg in (("jax", dataclasses.asdict(jn)),
                         ("port", tn.init_args)):
        save_json(os.path.join(runs[pkg], "nmt_config.json"),
                  {"model_type": "rnn", **nmt_cfg})
        for side, d in dicts.items():
            save_json(os.path.join(runs[pkg], f"{side}_dict.json"),
                      d.state_dict())
    return runs


def test_prepro_backtranslate_matches_jax(tmp_path, capsys):
    from unpaired_image_captioning_tpu.scripts import (
        prepro_backtranslate as jbt)

    from unpaired_image_captioning_tpu_torch.scripts import (
        prepro_backtranslate)

    runs = _nmt_runs(tmp_path)
    rs = np.random.RandomState(4)
    src = tmp_path / "zh.txt"
    src.write_text("\n".join(" ".join(f"w{j}" for j in rs.randint(
        0, 22, rs.randint(2, 7))) for _ in range(7)) + "\n")
    outs = {}
    for pkg, main, extra in (("jax", jbt.main, []),
                             ("port", prepro_backtranslate.main,
                              ["--device", "cpu"])):
        outs[pkg] = tmp_path / f"{pkg}.en"
        main(["--input", str(src), "--output", str(outs[pkg]),
              "--nmt_run", runs[pkg], "--beam_size", "3"] + extra)
    lines = outs["port"].read_text().splitlines()
    assert lines == outs["jax"].read_text().splitlines()
    assert len(lines) == 7 and len(set(lines)) > 1
    for main in (jbt.main, prepro_backtranslate.main):
        with pytest.raises(SystemExit, match="network access"):
            main(["--input", str(src), "--output", str(tmp_path / "g"),
                  "--provider", "google"])
