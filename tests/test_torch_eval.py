"""The port's evaluation (`eval/metrics/`, `eval/eval_utils.py`,
`native.py`, `scripts/prepro_split_tokenize.py::segment_zh`,
`ops/masking.py::seq_mask_from_labels`, `Trainer.eval`) against the JAX
package on the CPU.

Each metric equals JAX's exactly on the same gts / res, and
`language_eval` gives the same scores on the zh route (with jieba and with
its per-character route) and the coco route. `eval_split` on parameters
carried across by `bridge.params_from_jax` (a tiny denseatt captioner and
BiLSTM NMT) gives token-identical predictions at beam 1 and beam 2 under a
`num_images` budget, an XE val loss within 1e-5, equal `lang_stats` and
NMT valid ppl / accuracy within 1e-5. On the card (`cuda`, skipped here):
`eval_split` token-identical to the CPU on the same parameters.
"""

import json
import sys

import numpy as np
import pytest
import torch

from unpaired_image_captioning_tpu_torch import bridge, native
from unpaired_image_captioning_tpu_torch import models as tmodels
from unpaired_image_captioning_tpu_torch.config import Config as TConfig
from unpaired_image_captioning_tpu_torch.data import synthetic as tsyn
from unpaired_image_captioning_tpu_torch.data.arrays import read_arrays
from unpaired_image_captioning_tpu_torch.data.dataloader import (
    CaptionDataLoader)
from unpaired_image_captioning_tpu_torch.data.nmt_dataset import NMTDataset
from unpaired_image_captioning_tpu_torch.eval import eval_utils as teval
from unpaired_image_captioning_tpu_torch.eval import metrics as tmetrics
from unpaired_image_captioning_tpu_torch.models.nmt_transformer import (
    make_nmt_model)
from unpaired_image_captioning_tpu_torch.ops.masking import (
    seq_mask_from_labels)
from unpaired_image_captioning_tpu_torch.scripts.prepro_split_tokenize import (
    segment_zh)
from unpaired_image_captioning_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)
TOL = 1e-5
WORDS = ["a", "man", "dog", "rides", "the", "red", "bike", "on", "street",
         "two", "cats", "sleep", "running", "ran", "quickly"]
SCORERS = ["Bleu", "Cider", "CiderD", "Rouge", "Meteor", "Spice", "Ter"]
CFG = dict(caption_model="denseatt", vocab_size=30, rnn_size=24,
           num_layers=1, input_encoding_size=16, att_hid_size=16,
           fc_feat_size=32, att_feat_size=24, seq_length=8, drop_prob_lm=0.0,
           nmt_src_vocab_size=30, nmt_tgt_vocab_size=28, word_vec_size=16,
           layers=1, dropout=0.0, batch_size=3, seq_per_img=2)


def _gts_res(seed=0, n=6):
    rs = np.random.RandomState(seed)

    def sent():
        return " ".join(rs.choice(WORDS, rs.randint(2, 9)))

    gts = {i: [sent() for _ in range(rs.randint(1, 5))] for i in range(n)}
    res = {i: [sent()] for i in range(n)}
    res[0] = [gts[0][0]]          # one exact match
    return gts, res


@pytest.mark.parametrize("name", SCORERS)
def test_metric_matches_jax(name):
    from unpaired_image_captioning_tpu.eval import metrics as jmetrics

    gts, res = _gts_res()
    got = getattr(tmetrics, name)().compute_score(gts, res)
    want = getattr(jmetrics, name)().compute_score(gts, res)
    assert got == want


def test_corpus_scores_match_jax():
    from unpaired_image_captioning_tpu.eval import metrics as jmetrics
    from unpaired_image_captioning_tpu.eval.metrics import ter as jter

    from unpaired_image_captioning_tpu_torch.eval.metrics import ter as tter

    gts, res = _gts_res(1)
    hyps = [res[i][0].split() for i in sorted(res)]
    refs = [[r.split() for r in gts[i]] for i in sorted(gts)]
    assert (tmetrics.corpus_bleu(hyps, refs)
            == jmetrics.corpus_bleu(hyps, refs))
    assert (tmetrics.sentence_bleu(hyps[1], refs[1])
            == jmetrics.sentence_bleu(hyps[1], refs[1]))
    assert tter.corpus_ter(hyps, refs) == jter.corpus_ter(hyps, refs)


ZH_REFS = {0: ["一个 男人 在 街上 骑 自行车 。", "男人骑车"],
           1: ["两只猫在睡觉", "两 只 猫 睡觉 。"],
           2: ["a dog runs 在 草地上", "狗 跑"]}
ZH_PREDS = [{"image_id": 0, "caption": "一个男人骑自行车"},
            {"image_id": 1, "caption": "两只 狗 在 睡觉"},
            {"image_id": 2, "caption": "a dog 跑"}]


@pytest.mark.parametrize("route", ["zh", "zh_per_character", "coco"])
def test_language_eval_matches_jax(route, tmp_path, monkeypatch):
    from unpaired_image_captioning_tpu.eval import eval_utils as jeval

    if route == "zh_per_character":
        monkeypatch.setitem(sys.modules, "jieba", None)
    kind = route[:2] if route.startswith("zh") else "coco"
    refs, preds = ZH_REFS, ZH_PREDS
    if kind == "coco":
        gts, res = _gts_res(2)
        refs = gts
        preds = [{"image_id": i, "caption": r[0]} for i, r in res.items()]
    got = teval.language_eval(kind, preds, "m", "val", references=refs,
                              eval_results_dir=str(tmp_path / "t"))
    want = jeval.language_eval(kind, preds, "m", "val", references=refs,
                               eval_results_dir=str(tmp_path / "j"))
    assert got == want and set(got) >= {"Bleu_4", "CIDEr", "METEOR"}
    cache = f"{kind}_m_val.json"
    assert (json.load(open(tmp_path / "t" / cache))
            == json.load(open(tmp_path / "j" / cache)))


def test_native_build_falls_back_only_without_a_compiler(monkeypatch,
                                                        tmp_path):
    """No compiler: the Python tokenizer is the route. A compiler that
    fails: the build raises, naming the source."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    try:
        monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
        native._lib.cache_clear()
        assert not native.has_native()
        text = "A man's dog, isn't it?"
        assert native.ptb_tokenize(text) == native._ptb_tokenize_py(text)
        monkeypatch.setenv("CXX", "false")
        native._lib.cache_clear()
        with pytest.raises(RuntimeError, match="uic_native.cpp failed"):
            native.ptb_tokenize(text)
    finally:
        native._lib.cache_clear()


def test_tokenizers_match_jax(monkeypatch):
    from unpaired_image_captioning_tpu import native as jnative
    from unpaired_image_captioning_tpu.scripts import prepro_split_tokenize

    texts = ["A man's dog, isn't it? -- yes.", "café-au-lait x.y.z 男人。",
             "Two (red) bikes; ``quoted'' -LRB- ok"]
    assert native.has_native()
    for t in texts:
        assert native.ptb_tokenize(t) == jnative.ptb_tokenize(t)
        assert native._ptb_tokenize_py(t) == jnative._ptb_tokenize_py(t)
    monkeypatch.setitem(sys.modules, "jieba", None)
    for t in texts + ["一个男人 riding 自行车"]:
        assert segment_zh(t) == prepro_split_tokenize.segment_zh(t)


@pytest.mark.parametrize("first_eos", [True, False])
def test_seq_mask_from_labels_matches_jax(first_eos):
    from unpaired_image_captioning_tpu.ops import masking as jmask

    labels = np.array([[3, 4, 0, 0, 0], [0, 0, 0, 0, 0], [1, 2, 3, 4, 5],
                       [5, 0, 6, 0, 0]], np.int64)
    got = seq_mask_from_labels(torch.from_numpy(labels), first_eos)
    want = jmask.seq_mask_from_labels(labels, first_eos)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# eval_split on bridged parameters
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def eval_assets(tmp_path_factory):
    """Artifacts with 6 val images (the label file as .npz for the port
    and .h5 for JAX), the JAX models' parameters (the captioner's logits
    sharpened, EOS raised so some captions end early) and both loaders."""
    import h5py
    import jax

    from unpaired_image_captioning_tpu import models as jmodels
    from unpaired_image_captioning_tpu.config import Config
    from unpaired_image_captioning_tpu.models.nmt_transformer import (
        make_nmt_model as jmake_nmt)

    tmp = tmp_path_factory.mktemp("eval")
    jpath, npz, mem = tsyn.make_caption_artifacts(
        str(tmp), n_images=14, vocab_size=30, seq_length=8, n_val=6, seed=1)
    h5 = str(tmp / "label.h5")
    with h5py.File(h5, "w") as f:
        for k, v in read_arrays(npz).items():
            f[k] = v
    cfg = Config(**CFG)
    jm = jmodels.setup(cfg)
    jp = jm.init_params(jax.random.PRNGKey(0))
    logit = dict(jp["logit"][0])
    logit["w"] = logit["w"] * 40.0
    logit["b"] = logit["b"].at[0].add(0.5)
    jp = {**jp, "logit": [logit]}
    jn = jmake_nmt(cfg)
    jnp_ = jn.init_params(jax.random.PRNGKey(1))
    src, tgt = tsyn.make_nmt_corpus(n_pairs=7, seed=2)
    return dict(tmp=tmp, json=jpath, npz=npz, h5=h5, mem=mem, cfg=cfg,
                jm=jm, jp=jp, jn=jn, jnp=jnp_, src=src, tgt=tgt)


def _port_models(a, device="cpu"):
    tm = tmodels.setup(TConfig(**CFG), device=device)
    tm.load_state_dict(bridge.params_from_jax(a["jp"]))
    tn = make_nmt_model(TConfig(**CFG), device=device)
    tn.load_state_dict(bridge.params_from_jax(a["jnp"]))
    return tm, tn


def _port_loader(a, feat_dtype="float32"):
    return CaptionDataLoader(input_json=a["json"], input_label_h5=a["npz"],
                             in_memory=a["mem"], batch_size=3, seq_per_img=2,
                             att_feat_size=24, attri_feat_size=16,
                             feat_dtype=feat_dtype)


@pytest.mark.parametrize("beam", [1, 2])
def test_eval_split_matches_jax(eval_assets, beam, tmp_path, monkeypatch):
    from unpaired_image_captioning_tpu.data.dataloader import (
        CaptionDataLoader as JLoader)
    from unpaired_image_captioning_tpu.data.nmt_dataset import (
        NMTDataset as JNMT)
    from unpaired_image_captioning_tpu.eval import eval_utils as jeval

    a = eval_assets
    monkeypatch.chdir(tmp_path)
    jl = JLoader(input_json=a["json"], input_label_h5=a["h5"],
                 in_memory=a["mem"], batch_size=3, seq_per_img=2,
                 att_feat_size=24, attri_feat_size=16)
    tl = _port_loader(a)
    refs = tl.references("val")
    assert len(refs) == 6
    kw = dict(split="val", num_images=4, beam_size=beam,
              language_eval_refs=refs, model_id=f"b{beam}")
    want = jeval.eval_split(a["jm"], a["jp"], jl, **kw,
                            nmt_model=a["jn"], nmt_params=a["jnp"],
                            nmt_valid=JNMT(a["src"], a["tgt"], 3))
    tm, tn = _port_models(a)
    got = teval.eval_split(tm, tl, **kw, nmt_model=tn,
                           nmt_valid=NMTDataset(a["src"], a["tgt"], 3),
                           eval_results_dir="eval_results_port")
    assert got["predictions"] == want["predictions"]
    assert len(got["predictions"]) == 4
    # the sharpened logits give captions of several lengths
    assert len({len(p["caption"].split()) for p in got["predictions"]}) > 1
    assert abs(got["loss"] - want["loss"]) <= TOL * max(1.0, abs(want["loss"]))
    assert got["lang_stats"] == want["lang_stats"]
    for k in ("valid_ppl", "valid_acc"):
        assert abs(got["nmt_stats"][k] - want["nmt_stats"][k]) <= (
            TOL * max(1.0, abs(want["nmt_stats"][k])))


def test_eval_split_rounded_features_matches_jax(eval_assets, tmp_path,
                                                 monkeypatch):
    """Both loaders with feat_dtype="bfloat16" (the features the card's
    eval decodes): greedy predictions token-identical, the loss within
    1e-5."""
    from unpaired_image_captioning_tpu.data.dataloader import (
        CaptionDataLoader as JLoader)
    from unpaired_image_captioning_tpu.eval import eval_utils as jeval

    a = eval_assets
    monkeypatch.chdir(tmp_path)
    jl = JLoader(input_json=a["json"], input_label_h5=a["h5"],
                 in_memory=a["mem"], batch_size=3, seq_per_img=2,
                 att_feat_size=24, attri_feat_size=16, feat_dtype="bfloat16")
    want = jeval.eval_split(a["jm"], a["jp"], jl, split="val", beam_size=1,
                            model_id="bf")
    tm, _ = _port_models(a)
    got = teval.eval_split(tm, _port_loader(a, "bfloat16"), split="val",
                           beam_size=1, model_id="bf",
                           eval_results_dir="eval_results_port")
    assert got["predictions"] == want["predictions"]
    assert abs(got["loss"] - want["loss"]) <= TOL * max(1.0, abs(want["loss"]))


def test_trainer_eval_tracks_the_best(eval_assets, tmp_path, monkeypatch):
    a = eval_assets
    monkeypatch.chdir(tmp_path)
    tr = Trainer(TConfig(**CFG, id="t"), device="cpu")
    tm, tn = _port_models(a)
    tr.i2t_model.load_state_dict(tm.state_dict())
    tr.nmt_model.load_state_dict(tn.state_dict())
    loader = _port_loader(a)
    refs = loader.references("val")
    valid = NMTDataset(a["src"], a["tgt"], 3)
    first = tr.eval(loader, nmt_valid=valid, language_eval_refs=refs)
    assert first["is_best"] and tr.best_cider == first["lang_stats"]["CIDEr"]
    assert tr.best_nmt_acc == first["nmt_stats"]["valid_acc"]
    again = tr.eval(loader, nmt_valid=valid, language_eval_refs=refs)
    assert not again["is_best"]
    assert again["predictions"] == first["predictions"]
    # without references the score is -loss
    tr.best_cider = None
    plain = tr.eval(loader)
    assert plain["lang_stats"] is None and tr.best_cider == -plain["loss"]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("beam", [1, 3])
def test_cuda_eval_split_matches_cpu(cuda_dev, beam, tmp_path, monkeypatch):
    """`eval_split` through the kernels on the card and the plain versions
    on the CPU, on the same parameters and the same bf16-rounded features
    (the loader's feat_dtype="bfloat16"): token-identical predictions, the
    XE val loss within 1e-4 relative. On the card `eval_split` rounds f32
    features to bf16 itself (as JAX's does on a TPU) and the CPU does not,
    so both sides get the rounded features; the card's own rounding is
    held against the loader's `to_bfloat16`: the card on the f32 loader's
    features gives the same predictions and loss as on the bf16 loader's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    monkeypatch.chdir(tmp_path)
    jpath, npz, mem = tsyn.make_caption_artifacts(
        str(tmp_path), n_images=14, vocab_size=30, seq_length=8, n_val=6,
        seed=1)
    a = dict(json=jpath, npz=npz, mem=mem)
    cpu = tmodels.setup(TConfig(**CFG), device="cpu").init_params(
        torch.Generator().manual_seed(0))
    with torch.no_grad():
        cpu.logit[0].w.mul_(40.0)
    card = tmodels.setup(TConfig(**CFG), device=cuda_dev)
    card.load_state_dict(cpu.state_dict())
    outs = [teval.eval_split(m, _port_loader(a, "bfloat16"), beam_size=beam,
                             eval_results_dir=str(tmp_path / m.device.type))
            for m in (card, cpu)]
    assert outs[0]["predictions"] == outs[1]["predictions"]
    assert abs(outs[0]["loss"] - outs[1]["loss"]) <= 1e-4 * abs(
        outs[1]["loss"])
    own = teval.eval_split(card, _port_loader(a), beam_size=beam,
                           eval_results_dir=str(tmp_path / "f32"))
    assert own["predictions"] == outs[0]["predictions"]
    assert own["loss"] == outs[0]["loss"]
