"""The port's eval and migration CLIs (`cli/eval_unpaired.py`,
`cli/eval_pivot.py`, `cli/eval_paired.py`, `cli/translate.py`,
`eval_split_coco_unpaired` / `_paired`, `pivot.post_edit`, the new
`utils/text.py` functions) against the JAX package's CLIs on the CPU.

One run directory per package is written from the same parameters (a
tiny denseatt captioner from the JAX package's init, its logits
sharpened so that captions differ, and a BiLSTM NMT with standard normal
weights, which emits UNK): the JAX
one with `save_pytree`, the port's through `bridge.params_from_jax` and its
`CheckpointManager`, each with the `nmt_config.json` its trainer writes.
The JAX side runs with `--dtype float32` (its trainer's upload otherwise
rounds features to bf16).

- `eval_unpaired`: the same zh and en predictions (UNK replaced), the same
  result file; `eval_paired`: the same predictions and scores, the loss
  within 1e-5; `translate` with `-tgt`: the same output file, the printed
  PRED and GOLD reports equal to their 4 decimals, and the gold scores
  behind them within 1e-5; `eval_30k` offline: the same file and
  scores.
- The port's `eval_pivot` (the staged route through `translate`) gives
  its own `eval_unpaired`'s zh and en predictions.
- A second pair of run dirs holds a copy-attention NMT: `translate
  -copy_mode extended` and `fold`, and `eval_unpaired` (the align map,
  `pivot_translate` and `eval_split_coco_unpaired` with `src2tgt`) give
  the JAX CLIs' outputs.
- `src2tgt` on an NMT without copy attention changes nothing;
  `eval_paired --num_devices 2` on two CPU ranks writes what one device
  writes; `utils/text.py`'s
  converters and `self_bleu` equal JAX's.

On the card (`cuda`, skipped here): `cli.translate` on the card gives the
lines of its CPU run on the same run dir (near-ties aside).
"""

import dataclasses
import json
import os
import re
import sys

import numpy as np
import pytest
import torch

from unpaired_image_captioning_tpu_torch import bridge
from unpaired_image_captioning_tpu_torch import constants as C
from unpaired_image_captioning_tpu_torch.config import Config as TConfig
from unpaired_image_captioning_tpu_torch.data import synthetic as tsyn
from unpaired_image_captioning_tpu_torch.data.arrays import read_arrays
from unpaired_image_captioning_tpu_torch.train.checkpoint import (
    CheckpointManager, save_json)
from unpaired_image_captioning_tpu_torch.vocab import Dict

torch.set_num_threads(1)
TOL = 1e-5
ZH_V, TGT_V = 24, 30
N_TEST = 4
CFG = dict(caption_model="denseatt", vocab_size=ZH_V, rnn_size=16,
           num_layers=1, input_encoding_size=16, att_hid_size=12,
           fc_feat_size=32, att_feat_size=24, seq_length=6, drop_prob_lm=0.0,
           nmt_src_vocab_size=ZH_V + 4, nmt_tgt_vocab_size=TGT_V,
           word_vec_size=16, layers=1, dropout=0.0, batch_size=N_TEST,
           seq_per_img=2, beam_size=2)


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorflow", None)


def _dicts(copy=False):
    specials = [C.PAD_WORD, C.UNK_WORD, C.BOS_WORD, C.EOS_WORD]
    # the last two caption words are missing from the source dict (UNK)
    src = Dict(specials + [f"w{i}" for i in range(ZH_V - 2)])
    # for the copy runs the target dict shares w0..w4 (Dict.align maps
    # them); the other source words copy through the extended vocab
    tgt = Dict(specials + [f"w{i}" if copy and i < 5 else f"t{i}"
                           for i in range(TGT_V - 4)])
    return src, tgt


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return _make_runs(tmp_path_factory.mktemp("evalcli"))


@pytest.fixture(scope="module")
def copy_runs(tmp_path_factory):
    """The same, with a copy-attention NMT whose copy gate leans to copy."""
    return _make_runs(tmp_path_factory.mktemp("evalcli_copy"), copy=True)


def _make_runs(tmp, copy=False):
    import h5py
    import jax

    from unpaired_image_captioning_tpu import models as jmodels
    from unpaired_image_captioning_tpu.config import Config
    from unpaired_image_captioning_tpu.models.nmt import NMTModel as JNMT
    from unpaired_image_captioning_tpu.train.checkpoint import (
        CheckpointManager as JCkpt)

    cfg_kw = {**CFG, "copy_attn": copy}
    jpath, npz, mem = tsyn.make_caption_artifacts(
        str(tmp), n_images=10, vocab_size=ZH_V, seq_length=6,
        caps_per_img=2, n_val=2, n_test=N_TEST, seed=8)
    h5 = str(tmp / "label.h5")
    with h5py.File(h5, "w") as f:
        for k, v in read_arrays(npz).items():
            f[k] = v
    fc_dir, att_dir = tsyn.write_feature_dirs(str(tmp), mem)
    coco = str(tmp / "coco_refs.json")
    rs = np.random.RandomState(3)
    with open(coco, "w") as f:
        json.dump({str(i): [" ".join(f"t{j}" for j in rs.randint(0, 12, 5))
                            for _ in range(3)] for i in range(10)}, f)

    cfg = Config(**cfg_kw, dtype="float32")
    jm = jmodels.setup(cfg)
    jp = jm.init_params(jax.random.PRNGKey(0))
    logit = dict(jp["logit"][0])
    logit["w"] = logit["w"] * 40.0
    jp = {**jp, "logit": [logit]}
    jn = JNMT.from_config(cfg)
    # the NMT's init gives one output for every source: standard normal
    # weights instead, EOS and UNK raised, give translations of several
    # lengths with UNK, BOS and PAD among their tokens
    nrs = np.random.RandomState(1)
    jnp_ = jax.tree_util.tree_map(
        lambda x: nrs.randn(*x.shape).astype(np.float32),
        jn.init_params(jax.random.PRNGKey(1)))
    jnp_["generator"]["b"][C.EOS] += 2.0
    jnp_["generator"]["b"][C.UNK] += 2.0
    if copy:
        jnp_["copy_gate"]["b"][:] = 2.0
    src_dict, tgt_dict = _dicts(copy)

    jrun, trun = str(tmp / "jax_run"), str(tmp / "port_run")
    jck = JCkpt(jrun)
    for best in (False, True):
        jck.save(i2t_params=jp, nmt_params=jnp_,
                 infos={"opt": cfg.to_dict(), "iter": 1, "epoch": 0},
                 best=best)
    tck = CheckpointManager(trun)
    for best in (False, True):
        tck.save(i2t_state=bridge.params_from_jax(jp),
                 nmt_state=bridge.params_from_jax(jnp_),
                 infos={"opt": TConfig(**cfg_kw).to_dict(), "iter": 1,
                        "epoch": 0}, best=best)
    from unpaired_image_captioning_tpu_torch.models.nmt import NMTModel

    tn = NMTModel.from_config(TConfig(**cfg_kw), device="cpu")
    for run, nmt_cfg in ((jrun, {"model_type": "rnn",
                                 **dataclasses.asdict(jn)}),
                         (trun, {"model_type": "rnn", **tn.init_args})):
        save_json(os.path.join(run, "nmt_config.json"), nmt_cfg)
        for side, d in (("src", src_dict), ("tgt", tgt_dict)):
            save_json(os.path.join(run, f"{side}_dict.json"), d.state_dict())

    def argv(pkg, **kw):
        base = {"start_from": jrun if pkg == "jax" else trun,
                "input_json": jpath,
                "input_label_h5": h5 if pkg == "jax" else npz,
                "input_fc_dir": fc_dir, "input_att_dir": att_dir,
                "batch_size": str(N_TEST), "beam_size": "2",
                "language_eval": "1", "input_coco_json": coco, "id": "e"}
        base.update({"dtype": "float32"} if pkg == "jax"
                    else {"device": "cpu"})
        base.update({k: str(v) for k, v in kw.items()})
        return [x for k, v in base.items() for x in ("--" + k, v)]

    return dict(tmp=tmp, argv=argv, jrun=jrun, trun=trun)


def _in(path, fn):
    """fn() with the working directory at `path` (the CLIs write tmp/ and
    eval_results/ there)."""
    here = os.getcwd()
    os.makedirs(path, exist_ok=True)
    os.chdir(path)
    try:
        return fn()
    finally:
        os.chdir(here)


@pytest.fixture(scope="module")
def unpaired(runs):
    from unpaired_image_captioning_tpu.cli import eval_unpaired as jcli

    from unpaired_image_captioning_tpu_torch.cli import eval_unpaired

    out = {}
    for pkg, main in (("jax", jcli.main), ("port", eval_unpaired.main)):
        d = runs["tmp"] / f"unpaired_{pkg}"
        _in(d, lambda: main(runs["argv"](pkg)))
        with open(d / "eval_results" / "unpaired_e_test.json") as f:
            out[pkg] = json.load(f)
    return out


def test_eval_unpaired_matches_jax(unpaired):
    got, want = unpaired["port"], unpaired["jax"]
    assert got == want
    assert len(got["en_predictions"]) == N_TEST
    assert len({p["caption"] for p in got["zh_predictions"]}) > 1
    # UNK came out of the NMT and was replaced by a zh caption word
    assert any(re.search(r"\bw\d+", p["caption"])
               for p in got["en_predictions"])
    assert all(np.isfinite(v) for v in got["en_lang_stats"].values())


def test_eval_pivot_equals_eval_unpaired(runs, unpaired):
    from unpaired_image_captioning_tpu_torch.cli import eval_pivot

    staged = _in(runs["tmp"] / "pivot_port",
                 lambda: eval_pivot.main(runs["argv"]("port")))
    fused = unpaired["port"]
    for lang in ("zh", "en"):
        assert staged[f"{lang}_predictions"] == fused[f"{lang}_predictions"]
    assert staged["overall"] == fused["en_lang_stats"]
    assert (runs["tmp"] / "pivot_port" / "tmp" / "e_en_coco.txt").exists()


def test_eval_paired_matches_jax(runs):
    from unpaired_image_captioning_tpu.cli import eval_paired as jcli

    from unpaired_image_captioning_tpu_torch.cli import eval_paired

    out = {}
    for pkg, main in (("jax", jcli.main), ("port", eval_paired.main)):
        d = runs["tmp"] / f"paired_{pkg}"
        _in(d, lambda: main(runs["argv"](pkg, beam_size=1)))
        with open(d / "eval_results" / "paired_e_test.json") as f:
            out[pkg] = json.load(f)
    got, want = out["port"], out["jax"]
    assert got["predictions"] == want["predictions"]
    assert got["overall"] == want["overall"]
    assert abs(got["loss"] - want["loss"]) <= TOL * max(1.0, abs(want["loss"]))


def _scores(text):
    return {k: (float(a), float(b)) for k, a, b in re.findall(
        r"(PRED|GOLD) AVG SCORE: (\S+), \w+ PPL: (\S+)", text)}


def test_translate_matches_jax(runs, capsys):
    from unpaired_image_captioning_tpu.cli import translate as jcli

    from unpaired_image_captioning_tpu_torch.cli import translate

    tmp = runs["tmp"]
    rs = np.random.RandomState(4)
    src = [" ".join(f"w{j}" for j in rs.randint(0, ZH_V, rs.randint(1, 7)))
           for _ in range(6)] + [""]
    gold = [" ".join(f"t{j}" for j in rs.randint(0, TGT_V, rs.randint(1, 6)))
            for _ in range(7)]
    (tmp / "zh.txt").write_text("\n".join(src) + "\n")
    (tmp / "gold.txt").write_text("\n".join(gold) + "\n")
    out, printed = {}, {}
    for pkg, main, run, extra in (
            ("jax", jcli.main, runs["jrun"], []),
            ("port", translate.main, runs["trun"], ["-device", "cpu"])):
        path = str(tmp / f"en_{pkg}.txt")
        capsys.readouterr()
        main(["-model", run, "-src", str(tmp / "zh.txt"), "-tgt",
              str(tmp / "gold.txt"), "-output", path, "-batch_size", "3",
              "-beam_size", "3"] + extra)
        printed[pkg] = _scores(capsys.readouterr().out)
        out[pkg] = open(path).read()
    assert out["port"] == out["jax"]
    assert len(out["port"].splitlines()) == 7
    # the reports print 4 decimals: the average scores equal up to one
    # unit of the last, and so their exponentials, the PPLs, relatively
    assert sorted(printed["port"]) == sorted(printed["jax"]) == ["GOLD",
                                                                 "PRED"]
    for k, (score, ppl) in printed["jax"].items():
        got = printed["port"][k]
        assert abs(got[0] - score) <= 1.5e-4
        assert abs(got[1] - ppl) <= 1.5e-4 * ppl + 1.5e-4
    # the gold scores behind GOLD AVG SCORE, sentence by sentence
    jm = jcli_model(runs["jrun"])
    tm = translate.load_nmt_run(runs["trun"], "cpu")[0]
    src, lengths, tgt = _gold_batch(src, gold)
    want = np.asarray(jm[0].gold_scores(jm[1], src, lengths, tgt))
    with torch.no_grad():
        got = tm.gold_scores(*(torch.from_numpy(a).long()
                               for a in (src, lengths, tgt))).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("mode", ["extended", "fold"])
def test_translate_copy_modes_match_jax(copy_runs, mode):
    """`-copy_mode` on a copy-attention run: the same output file as the
    JAX CLI's; the extended mode decodes exact copies of source words the
    target dict lacks (w5 and up), the fold mode copies only through
    aligned words and UNK replacement. The decode stops at 20 tokens, the
    pivot's NMT length: on these standard normal weights the two
    frameworks' per-step logprobs differ by up to about 1e-5 (summation
    order, with or without the copy scatter), and over 100 steps such noise
    flips a near tie late in one of the 8 lines (step 81)."""
    from unpaired_image_captioning_tpu.cli import translate as jcli

    from unpaired_image_captioning_tpu_torch.cli import translate

    tmp = copy_runs["tmp"]
    rs = np.random.RandomState(5)
    src = [" ".join(f"w{j}" for j in rs.randint(0, ZH_V, rs.randint(2, 7)))
           for _ in range(8)]
    (tmp / "zh.txt").write_text("\n".join(src) + "\n")
    out = {}
    for pkg, main, run, extra in (
            ("jax", jcli.main, copy_runs["jrun"], []),
            ("port", translate.main, copy_runs["trun"], ["-device", "cpu"])):
        path = str(tmp / f"en_{mode}_{pkg}.txt")
        main(["-model", run, "-src", str(tmp / "zh.txt"), "-output", path,
              "-batch_size", "4", "-beam_size", "3", "-copy_mode", mode,
              "-max_sent_length", "20"]
             + extra)
        out[pkg] = open(path).read()
    assert out["port"] == out["jax"]
    assert re.search(r"\bw\d+", out["port"])


def test_eval_unpaired_copy_matches_jax(copy_runs):
    """`eval_unpaired` on a copy-attention run builds src_dict.align(tgt_dict)
    and decodes the pivot over the extended vocab (`pivot_translate` and
    `eval_split_coco_unpaired` with `src2tgt`): the same result file as the
    JAX CLI's, with source words in the en captions."""
    from unpaired_image_captioning_tpu.cli import eval_unpaired as jcli

    from unpaired_image_captioning_tpu_torch.cli import eval_unpaired

    out = {}
    for pkg, main in (("jax", jcli.main), ("port", eval_unpaired.main)):
        d = copy_runs["tmp"] / f"unpaired_{pkg}"
        _in(d, lambda: main(copy_runs["argv"](pkg)))
        with open(d / "eval_results" / "unpaired_e_test.json") as f:
            out[pkg] = json.load(f)
    assert out["port"] == out["jax"]
    assert all(p["caption"] for p in out["port"]["en_predictions"])
    assert any(re.search(r"\bw\d+", p["caption"])
               for p in out["port"]["en_predictions"])


def jcli_model(run):
    """The JAX NMT of run dir `run` as its translate CLI builds it."""
    import jax

    from unpaired_image_captioning_tpu.models.nmt import NMTModel as JNMT
    from unpaired_image_captioning_tpu.train.checkpoint import (load_json,
                                                                load_pytree)

    cfg = load_json(os.path.join(run, "nmt_config.json"))
    cfg.pop("model_type")
    model = JNMT(**cfg)
    params = load_pytree(os.path.join(run, "model_nmt.msgpack"),
                         model.init_params(jax.random.PRNGKey(0)))
    return model, params


def _gold_batch(src_lines, gold_lines):
    """(src, lengths, tgt) ids of the lines as the translate CLIs build
    them, one batch."""
    src_dict, tgt_dict = _dicts()
    toks = [l.split() for l in src_lines]
    src = np.zeros((len(toks), max(max(map(len, toks)), 1)), np.int32)
    for i, t in enumerate(toks):
        ids = src_dict.convert_to_idx(t, C.UNK_WORD)
        src[i, :len(ids)] = ids
    gold = [l.split() for l in gold_lines]
    tgt = np.zeros((len(gold), max(map(len, gold)) + 2), np.int32)
    for i, t in enumerate(gold):
        ids = tgt_dict.convert_to_idx(t, C.UNK_WORD, bos_word=C.BOS_WORD,
                                      eos_word=C.EOS_WORD)
        tgt[i, :len(ids)] = ids
    return src, np.maximum((src != 0).sum(1), 1).astype(np.int32), tgt


def test_eval_30k_offline_matches_jax(runs):
    from unpaired_image_captioning_tpu.cli import eval_unpaired as jcli

    from unpaired_image_captioning_tpu_torch.cli import eval_unpaired

    tmp = runs["tmp"]
    lines = ["there is a dog on the grass", "Two Cats sleep",
             "a man rides a red bike"]
    (tmp / "caps.txt").write_text("\n".join(lines) + "\n")
    with open(tmp / "flickr.json", "w") as f:
        json.dump({"0": ["a dog on grass"], "1": ["two cats sleeping"],
                   "2": ["a man rides a bike", "a red bike"]}, f)
    out = {}
    for pkg, main in (("jax", jcli.eval_30k), ("port",
                                               eval_unpaired.eval_30k)):
        d = tmp / f"30k_{pkg}"
        res = _in(d, lambda: main(str(tmp / "caps.txt"),
                                  flickr_refs=str(tmp / "flickr.json")))
        out[pkg] = (res["overall"],
                    open(d / res["predictions_json"]).read())
    assert out["port"] == out["jax"]
    assert out["port"][0]["CIDEr"] > 0


def test_unported_options_raise(runs, tmp_path):
    from unpaired_image_captioning_tpu_torch.cli import eval_paired
    from unpaired_image_captioning_tpu_torch.eval import eval_utils

    # --bn_calibrate runs since A10 (tests/test_torch_batchnorm.py);
    # --num_devices 2 since A14: two CPU ranks decode a block each, and
    # rank 0 writes what one device writes
    outs = {n: _in(tmp_path / f"ranks{n}", lambda n=n: eval_paired.main(
        runs["argv"]("port", num_devices=n))) for n in (1, 2)}
    assert outs[2]["predictions"] == outs[1]["predictions"]
    assert outs[2]["lang_stats"] == outs[1]["lang_stats"]
    np.testing.assert_allclose(outs[2]["loss"], outs[1]["loss"], rtol=1e-6)
    written = [(tmp_path / f"ranks{n}" / "eval_results" / "paired_e_test.json"
                ).read_text() for n in (1, 2)]
    assert written[0] == written[1]
    # src2tgt runs: handed to an NMT without copy attention (the CLI
    # passes it only to a copy model) it changes no prediction
    from unpaired_image_captioning_tpu_torch.cli import eval_unpaired

    plain = eval_utils.eval_split_coco_unpaired

    def with_map(*a, **kw):
        assert kw.pop("src2tgt") is None
        return plain(*a, src2tgt=np.arange(ZH_V + 4), **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(eval_utils, "eval_split_coco_unpaired", with_map)
    try:
        got = _in(tmp_path, lambda: eval_unpaired.main(runs["argv"]("port")))
    finally:
        mp.undo()
    want = _in(tmp_path / "plain",
               lambda: eval_unpaired.main(runs["argv"]("port")))
    assert got["en_predictions"] == want["en_predictions"]


def test_text_utils_match_jax(tmp_path):
    from unpaired_image_captioning_tpu.utils import text as jtext

    from unpaired_image_captioning_tpu_torch.utils import text as ttext

    preds = [{"image_id": 3, "caption": " a dog runs "},
             {"image_id": 5, "caption": "two cats"}]
    src = tmp_path / "p.json"
    src.write_text(json.dumps(preds))
    for name, mod in (("jax", jtext), ("port", ttext)):
        mod.cocojson2text(str(src), str(tmp_path / f"{name}.txt"))
        mod.json2text(str(src), str(tmp_path / f"{name}2.txt"))
        mod.text2textid(str(tmp_path / f"{name}.txt"), [3, 5],
                        str(tmp_path / f"{name}.tsv"))
        mod.text2cocojson(str(tmp_path / f"{name}.txt"), [3, 5],
                          str(tmp_path / f"{name}.json"))
    for ext in (".txt", "2.txt", ".tsv", ".json"):
        assert (tmp_path / f"port{ext}").read_text() == (
            tmp_path / f"jax{ext}").read_text()
    sents = ["a dog runs on the grass", "a dog runs", "two cats sleep",
             "a man rides a red bike on the street"]
    for sample in (None, 2):
        assert ttext.self_bleu(sents, sample=sample) == jtext.self_bleu(
            sents, sample=sample)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_translate_matches_cpu(cuda_dev, tmp_path):
    """`cli.translate` on the card (B1 and B2) and on the CPU on one port
    run dir (written here without JAX: the NMT with standard normal
    weights): at least 10 of 12 lines identical, near-ties aside."""
    from unpaired_image_captioning_tpu_torch.cli import translate
    from unpaired_image_captioning_tpu_torch.models.nmt import NMTModel

    torch.backends.cuda.matmul.allow_tf32 = False
    nmt = NMTModel.from_config(TConfig(**CFG), device="cpu")
    gen = torch.Generator().manual_seed(1)
    state = {k: torch.randn(v.shape, generator=gen)
             for k, v in nmt.state_dict().items()}
    state["generator.b"][C.EOS] += 2.0
    state["generator.b"][C.UNK] += 2.0
    run = tmp_path / "run"
    CheckpointManager(str(run)).save(nmt_state=state)
    save_json(str(run / "nmt_config.json"),
              {"model_type": "rnn", **nmt.init_args})
    for side, d in zip(("src", "tgt"), _dicts()):
        save_json(str(run / f"{side}_dict.json"), d.state_dict())
    rs = np.random.RandomState(5)
    (tmp_path / "zh.txt").write_text("\n".join(
        " ".join(f"w{j}" for j in rs.randint(0, ZH_V, rs.randint(1, 7)))
        for _ in range(12)) + "\n")
    outs = {}
    for dev in ("cuda", "cpu"):
        path = tmp_path / f"en_{dev}.txt"
        translate.main(["-model", str(run), "-src", str(tmp_path / "zh.txt"),
                        "-output", str(path), "-device", dev])
        outs[dev] = path.read_text().splitlines()
    same = sum(a == b for a, b in zip(outs["cuda"], outs["cpu"]))
    assert len(outs["cuda"]) == 12 and same >= 10, outs
