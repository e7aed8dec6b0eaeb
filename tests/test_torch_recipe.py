"""The port's training CLI (`cli/train.py`, `config.py`,
`train/checkpoint.py`, `train/logging.py`, the optimizer's state and
`Trainer.save` / `load`) on synthetic artifacts at tiny widths.

- Against the JAX CLI on the same argv (plus `--device cpu` for the
  port, and `--dtype float32` for both, whose trainers otherwise round the
  features to bf16 on the host before upload, on the CPU too): denseatt
  jointly with the BiLSTM NMT under Weight_Trans and Weight_Trans_y, XE
  only, every dropout 0, no scheduled sampling, Adam on both models with
  eps 1e-6 (the parity trap of ROADMAP §C), three epochs (eval_split is
  held against JAX's in tests/test_torch_eval.py);
  both CLIs start from the JAX trainer's initial parameters (the test
  loads them into the port's trainer). The final parameters agree within
  TOL = 1e-5 and so does every loss in `events.jsonl`.
- The port alone: the XE -> SCST switch (`avg_reward` exactly from
  `self_critical_after` on, with `language_eval` at beam 2 and finite
  `lang_stats`); stopping at the switch and resuming with `--start_from`
  lands on the single run's parameters and optimizer state bit for bit;
  a width mismatch on resume raises; a step that raises leaves an
  emergency checkpoint; the options that are not ported raise. A corpus
  with source-feature streams trains as it does through the JAX CLI.
- The config's parser, checkpoint merge and `transfer_args`, the
  optimizer's state dict, the checkpoint files, the metric log and
  pretrained NMT word vectors against the JAX package.

On the card (`cuda`, skipped here): a `Trainer.save` / `load` round trip.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

from unpaired_image_captioning_tpu_torch import bridge
from unpaired_image_captioning_tpu_torch import constants as C
from unpaired_image_captioning_tpu_torch import config as tconfig
from unpaired_image_captioning_tpu_torch.cli import train as tcli
from unpaired_image_captioning_tpu_torch.data import synthetic as tsyn
from unpaired_image_captioning_tpu_torch.data.arrays import read_arrays
from unpaired_image_captioning_tpu_torch.data.nmt_dataset import NMTDataset
from unpaired_image_captioning_tpu_torch.scripts import prepro_ngrams
from unpaired_image_captioning_tpu_torch.train import checkpoint as tckpt
from unpaired_image_captioning_tpu_torch.train import trainer as ttrainer
from unpaired_image_captioning_tpu_torch.train.logging import MetricLogger
from unpaired_image_captioning_tpu_torch.train.optimizer import (
    DualOptim, PlateauScheduler)
from unpaired_image_captioning_tpu_torch.vocab import Dict

torch.set_num_threads(1)
TOL = 1e-5
ZH_V = 24
LOSS_KEYS = ("i2t_loss", "nmt_loss", "nmt_ppl", "nmt_acc", "wemb_loss",
             "wemb_y_loss", "total_loss", "val_loss", "avg_reward",
             "valid_ppl", "valid_acc")


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    """Both MetricLoggers skip their optional TensorBoard writer (its
    tensorflow import costs seconds); the tests read events.jsonl."""
    monkeypatch.setitem(sys.modules, "tensorflow", None)


def _mk_dict(labels_by_id):
    d = Dict([C.PAD_WORD, C.UNK_WORD, C.BOS_WORD, C.EOS_WORD])
    for i, lab in labels_by_id.items():
        d.idx_to_label[i] = lab
        d.label_to_idx[lab] = i
    return d


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """Caption artifacts (labels as .npz and .h5, features as
    directories), a zh->en corpus over the caption words (.npz and .h5,
    train and valid), the NMT dicts, a frozen en embedding for
    Weight_Trans_y and the df cache of the port's prepro_ngrams."""
    import h5py

    tmp = tmp_path_factory.mktemp("recipe")
    jpath, npz, mem = tsyn.make_caption_artifacts(
        str(tmp), vocab_size=ZH_V, seq_length=6, caps_per_img=2, seed=5)
    h5 = str(tmp / "label.h5")
    with h5py.File(h5, "w") as f:
        for k, v in read_arrays(npz).items():
            f[k] = v
    fc_dir, att_dir = tsyn.write_feature_dirs(str(tmp), mem)
    rng = np.random.RandomState(0)
    src = rng.randint(4, 4 + ZH_V, (96, 6)).astype(np.int32)
    tgt = np.zeros((96, 8), np.int32)
    tgt[:, 0] = C.BOS
    tgt[:, 1:7] = src + 8
    tgt[:, 7] = C.EOS
    for split, rows in (("train", slice(0, 96)), ("valid", slice(0, 8))):
        np.savez(str(tmp / f"nmt.{split}.npz"), src=src[rows], tgt=tgt[rows])
        with h5py.File(str(tmp / f"nmt.{split}.h5"), "w") as f:
            f["src"], f["tgt"] = src[rows], tgt[rows]
    dicts = str(tmp / "dicts.json")
    with open(dicts, "w") as f:
        json.dump({"src": _mk_dict({i + 4: f"w{i}" for i in range(ZH_V)})
                   .state_dict(),
                   "tgt": _mk_dict({j + 4: f"t{j}" for j in range(36)})
                   .state_dict()}, f)
    coco_json = str(tmp / "coco.json")
    with open(coco_json, "w") as f:
        json.dump({"ix_to_word": {str(i): f"t{i - 1}"
                                  for i in range(1, 20)}}, f)
    coco_wemb = str(tmp / "coco_wemb.npz")
    np.savez(coco_wemb, embedding=rng.randn(20, 16).astype(np.float32))
    ngrams = str(tmp / "ngrams.npz")
    prepro_ngrams.main(["--input_label_h5", npz, "--input_json", jpath,
                        "--output", ngrams])

    def argv(run, fmt="npz", **kw):
        base = {
            "caption_model": "denseatt", "input_json": jpath,
            "input_label_h5": npz if fmt == "npz" else h5,
            "input_fc_dir": fc_dir, "input_att_dir": att_dir,
            "i2t_train_flag": "true", "nmt_train_flag": "true",
            "input_nmt_h5": str(tmp / f"nmt.train.{fmt}"),
            "input_nmt_dict": dicts, "input_coco_json": coco_json,
            "input_coco_wemb": coco_wemb, "cached_tokens": ngrams,
            "batch_size": "4", "seq_per_img": "2", "rnn_size": "16",
            "input_encoding_size": "16", "att_hid_size": "12",
            "fc_feat_size": "32", "att_feat_size": "24", "num_layers": "1",
            "word_vec_size": "16", "layers": "1", "drop_prob_lm": "0",
            "dropout": "0", "i2t_learning_rate": "1e-2",
            "i2t_optim_epsilon": "1e-6", "nmt_optim": "adam",
            "nmt_learning_rate": "5e-3", "nmt_optim_epsilon": "1e-6",
            "max_epochs": "3", "losses_log_every": "1",
            "save_checkpoint_every": "1000", "num_devices": "1",
            "checkpoint_path": run, "id": os.path.basename(run),
        }
        base.update({k: str(v) for k, v in kw.items()})
        out = []
        for k, v in base.items():
            out += ["--" + k, v]
        return out

    return {"tmp": tmp, "argv": argv}


def _events(run):
    with open(os.path.join(run, "events.jsonl")) as f:
        return [json.loads(line) for line in f]


def _port(argv):
    return list(argv) + ["--device", "cpu"]


def test_cli_matches_jax_cli(assets, monkeypatch):
    import jax

    from unpaired_image_captioning_tpu.cli import train as jcli
    from unpaired_image_captioning_tpu.train import trainer as jtrainer

    tmp = assets["tmp"]
    monkeypatch.chdir(tmp)
    made = {}

    class JTrainer(jtrainer.Trainer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made["jax"] = self
            made["init"] = (jax.tree.map(np.asarray, self.i2t_params),
                            jax.tree.map(np.asarray, self.nmt_params))

    class TTrainer(ttrainer.Trainer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            i2t, nmt = made["init"]
            self.i2t_model.load_state_dict(bridge.params_from_jax(i2t))
            self.nmt_model.load_state_dict(bridge.params_from_jax(nmt))

    monkeypatch.setattr(jtrainer, "Trainer", JTrainer)
    monkeypatch.setattr(ttrainer, "Trainer", TTrainer)
    kw = dict(fmt="h5")
    jrun, trun = str(tmp / "jax_run"), str(tmp / "port_run")
    jcli.main(assets["argv"](jrun, **kw) + ["--dtype", "float32"])
    got = tcli.main(_port(assets["argv"](trun, **kw)) + ["--dtype", "float32"])
    jt = made["jax"]
    assert got.iteration == jt.iteration == 7
    for model, params in ((got.i2t_model, jt.i2t_params),
                          (got.nmt_model, jt.nmt_params)):
        want = bridge.params_from_jax(jax.tree.map(np.asarray, params))
        have = model.state_dict()
        assert set(have) == set(want)
        for k in want:
            np.testing.assert_allclose(have[k].numpy(), want[k].numpy(),
                                       rtol=TOL, atol=TOL, err_msg=k)
    ev_t, ev_j = _events(trun), _events(jrun)
    assert len([e for e in ev_t if "total_loss" in e]) == 7
    # the port also logs each eval's and each checkpoint's wall
    ev_t = [e for e in ev_t if set(e) - {"step", "time", "save_time"}]
    assert len(ev_t) == len(ev_j)
    for et, ej in zip(ev_t, ev_j):
        assert et["step"] == ej["step"]
        keys = [k for k in LOSS_KEYS if k in ej]
        assert keys and set(keys) == {k for k in LOSS_KEYS if k in et}
        for k in keys:
            assert abs(et[k] - ej[k]) <= TOL * max(1.0, abs(ej[k])), (k, et)
    # the two checkpoints hold the same counters and the dicts beside them
    for name in ("src_dict.json", "tgt_dict.json"):
        assert (json.load(open(os.path.join(trun, name)))
                == json.load(open(os.path.join(jrun, name))))
    jinfos = json.load(open(os.path.join(jrun, "infos.json")))
    tinfos = json.load(open(os.path.join(trun, "infos.json")))
    for k in ("iter", "epoch", "epoch_nmt", "loader_state"):
        assert tinfos[k] == jinfos[k], k


def test_scst_switch_and_resume_bit_for_bit(assets, monkeypatch):
    """The XE -> SCST switch at `self_critical_after`, and stop-then-resume
    landing on the single run's parameters and optimizer state exactly
    (JAX tests/test_joint_recipe.py part (c))."""
    tmp = assets["tmp"]
    kw = dict(self_critical_after=2, drop_prob_lm="0.3", dropout="0.2",
              save_checkpoint_every=3, language_eval=1, beam_size=2,
              load_best_score=0)
    full, half = str(tmp / "full"), str(tmp / "half")
    monkeypatch.chdir(tmp)
    tr_full = tcli.main(_port(assets["argv"](full, **kw)))
    ev = _events(full)
    steps = [e for e in ev if "total_loss" in e]
    assert [e["step"] for e in steps] == list(range(1, 8))
    first_rl = next(i for i, e in enumerate(steps) if "avg_reward" in e)
    # the switch happens at the step that starts epoch 2
    assert steps[first_rl - 1]["epoch"] == 2 and first_rl == 5
    assert all("avg_reward" in e for e in steps[first_rl:])
    assert all(np.isfinite(e["avg_reward"]) for e in steps[first_rl:])
    hist = json.load(open(os.path.join(full, "histories.json")))
    for val in hist["val_result_history"].values():
        assert all(np.isfinite(v) for v in val["lang_stats"].values())
        assert np.isfinite(val["nmt_stats"]["valid_ppl"])
    for name in ("model_i2t", "model_nmt", "optimizer"):
        assert os.path.exists(os.path.join(full, f"{name}-best.pt"))
    assert json.load(open(os.path.join(full, "nmt_config.json")))[
        "model_type"] == "rnn"

    tcli.main(_port(assets["argv"](half, **dict(kw, max_epochs=2))))
    tr_half = tcli.main(_port(assets["argv"](half, **kw, start_from=half)))
    assert tr_half.iteration == tr_full.iteration == 7
    for a, b in ((tr_full.i2t_model, tr_half.i2t_model),
                 (tr_full.nmt_model, tr_half.nmt_model)):
        for (k, x), (k2, y) in zip(a.state_dict().items(),
                                   b.state_dict().items()):
            assert k == k2 and torch.equal(x, y), k
    sa, sb = tr_full.optim.state_dict(), tr_half.optim.state_dict()
    flat_a, flat_b = [], []
    for s, out in ((sa, flat_a), (sb, flat_b)):
        for side in ("i2t_state", "nmt_state"):
            for part in s[side]:
                for v in part.values():
                    out.extend(v.values() if isinstance(v, dict) else [v])
    assert len(flat_a) == len(flat_b) > 0
    for x, y in zip(flat_a, flat_b):
        assert (torch.equal(x, y) if isinstance(x, torch.Tensor)
                else x == y)
    assert torch.equal(tr_full.generator.get_state(),
                       tr_half.generator.get_state())
    ev_half = [e for e in _events(half) if "total_loss" in e]
    assert [e["total_loss"] for e in ev_half] == [
        e["total_loss"] for e in steps]


def test_resume_refuses_another_width(assets, monkeypatch):
    tmp = assets["tmp"]
    run = str(tmp / "narrow")
    monkeypatch.chdir(tmp)
    tcli.main(_port(assets["argv"](run, max_epochs=1)))
    with pytest.raises(ValueError, match="resume mismatch on 'rnn_size'"):
        tcli.main(_port(assets["argv"](run, max_epochs=2, rnn_size=20,
                                       start_from=run, load_best_score=0)))
    with pytest.raises(ValueError, match="num_layers"):
        tckpt.check_resume_compat({"num_layers": 2},
                                  tconfig.Config(num_layers=1))


def test_emergency_checkpoint_when_a_step_raises(assets, monkeypatch):
    tmp = assets["tmp"]
    run = str(tmp / "crash")
    monkeypatch.chdir(tmp)
    real = ttrainer.Trainer.train

    def train(self, data, **kw):
        if self.iteration == 2:
            raise FloatingPointError("boom")
        return real(self, data, **kw)

    monkeypatch.setattr(ttrainer.Trainer, "train", train)
    with pytest.raises(FloatingPointError, match="boom"):
        tcli.main(_port(assets["argv"](run)))
    infos = json.load(open(os.path.join(run, "infos.json")))
    assert infos["iter"] == 2 and "boom" in infos["crash"]
    # the third batch wrapped the 8 training images before the step raised
    assert infos["loader_state"]["iterators"]["train"] == 4
    for name in ("model_i2t", "model_nmt"):
        assert os.path.exists(os.path.join(run, f"{name}.pt"))
    assert not [f for f in os.listdir(run) if ".tmp." in f]


@pytest.mark.parametrize("flag,item", [("input_workers", "A9"),
                                       ("num_devices", "A14")])
def test_unported_cli_options_raise(assets, flag, item):
    """Both options have landed, so neither raises. The feature workers of
    A9: `--input_workers 2` trains through to the end
    (tests/test_torch_prefetch.py holds the run against one without).
    Scale-out (A14): `--num_devices 2` trains on two CPU ranks over gloo,
    and its final checkpoint equals the one-device run's within 1e-5."""
    # dtype f32: the f32 tolerance below (the default is "bfloat16")
    argv = _port(assets["argv"](str(assets["tmp"] / f"x_{flag}"),
                                **{flag: 2}, max_epochs=1, dtype="float32"))
    if flag == "input_workers":
        trainer = tcli.main(argv)
        assert trainer.epoch == 1 and trainer.iteration == 3
        return
    summary = tcli.main(argv)
    assert summary["epoch"] == 1 and summary["iter"] == 3
    one = str(assets["tmp"] / "x_one_device")
    tcli.main(_port(assets["argv"](one, num_devices=1, max_epochs=1,
                                   dtype="float32")))
    for name in ("model_i2t", "model_nmt"):
        got = torch.load(os.path.join(assets["tmp"], f"x_{flag}",
                                      f"{name}.pt"), weights_only=True)
        want = torch.load(os.path.join(one, f"{name}.pt"),
                          weights_only=True)
        assert set(got) == set(want)
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=1e-5,
                                       atol=1e-5)


def test_featured_corpus_raises(assets, tmp_path, monkeypatch):
    """C4, closed by the source features: a corpus with two source-feature
    streams (`src_feat_0`, `src_feat_1`) sizes `nmt_src_feature_sizes` as
    the JAX CLI does and trains the BiLSTM NMT with one feature LUT a
    stream. From the JAX trainer's initial parameters, the NMT losses in
    `events.jsonl` and the final NMT parameters equal the JAX CLI's on the
    same argv (NMT training only) within TOL; the feature LUTs move. The
    trainer, handed such a batch directly, takes it too."""
    import h5py
    import jax

    from unpaired_image_captioning_tpu.cli import train as jcli
    from unpaired_image_captioning_tpu.train import trainer as jtrainer

    blob = read_arrays(str(assets["tmp"] / "nmt.train.npz"))
    feats = {"src_feat_0": blob["src"] % 3, "src_feat_1": blob["src"] % 5}
    featured = str(tmp_path / "nmt.train.h5")
    with h5py.File(featured, "w") as f:
        for k, v in {**blob, **feats}.items():
            f[k] = v
    made = {}

    class JTrainer(jtrainer.Trainer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made["jax"] = self
            made["init"] = jax.tree.map(np.asarray, self.nmt_params)

    class TTrainer(ttrainer.Trainer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made["port"] = self
            self.nmt_model.load_state_dict(
                bridge.params_from_jax(made["init"]))

    monkeypatch.setattr(jtrainer, "Trainer", JTrainer)
    monkeypatch.setattr(ttrainer, "Trainer", TTrainer)
    monkeypatch.chdir(tmp_path)
    kw = dict(fmt="h5", input_nmt_h5=featured, i2t_train_flag="false",
              max_epochs=1)
    jrun, trun = str(tmp_path / "jax_run"), str(tmp_path / "port_run")
    jcli.main(assets["argv"](jrun, **kw) + ["--dtype", "float32"])
    got = tcli.main(_port(assets["argv"](trun, **kw)) + ["--dtype", "float32"])
    assert got.cfg.nmt_src_feature_sizes == made["jax"].cfg \
        .nmt_src_feature_sizes == (3, 5)
    want = bridge.params_from_jax(jax.tree.map(np.asarray,
                                               made["jax"].nmt_params))
    have = got.nmt_model.state_dict()
    assert set(have) == set(want)
    for k in want:
        np.testing.assert_allclose(have[k].numpy(), want[k].numpy(),
                                   rtol=TOL, atol=TOL, err_msg=k)
    lut0 = "encoder.embeddings.feature_luts.0"
    assert not np.array_equal(have[lut0].numpy(),
                              made["init"]["encoder"]["embeddings"]
                              ["feature_luts"][0])
    ev_t = [e for e in _events(trun) if "nmt_loss" in e]
    ev_j = [e for e in _events(jrun) if "nmt_loss" in e]
    assert len(ev_t) == len(ev_j) > 0
    for et, ej in zip(ev_t, ev_j):
        np.testing.assert_allclose(et["nmt_loss"], ej["nmt_loss"],
                                   rtol=TOL, atol=TOL)
    monkeypatch.undo()
    tr = ttrainer.Trainer(tconfig.Config(
        nmt_src_vocab_size=30, nmt_tgt_vocab_size=40, word_vec_size=8,
        rnn_size=8, nmt_train_flag=True, nmt_src_feature_sizes=(3,)),
        device="cpu")
    nb = NMTDataset(blob["src"], blob["tgt"], 4,
                    src_feats=[blob["src"] % 3]).next_batch()[0]
    assert np.isfinite(float(tr.train({"nmt": nb})["nmt_loss"]))


def test_cli_defaults_to_the_card(assets, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(assets["argv"](str(assets["tmp"] / "y")))


# ---------------------------------------------------------------------------
# the config, the optimizer's state, the checkpoint files, the log
# ---------------------------------------------------------------------------

ARGV = ["--caption_model", "denseatt", "--rnn_size", "64", "--brnn", "false",
        "--gpus", "0", "1", "--fertility", "0.5", "--start_from", "run",
        "--i2t_learning_rate", "1e-3", "--id", "x", "--language_eval", "1"]


def test_parse_opt_matches_jax():
    from unpaired_image_captioning_tpu import config as jconfig

    got = tconfig.parse_opt(ARGV + ["--device", "cpu"]).to_dict()
    want = jconfig.parse_opt(ARGV).to_dict()
    assert got.pop("device") == "cpu"
    # the compute dtype's default: bf16 in both (ROADMAP A15)
    assert got.pop("dtype") == want.pop("dtype") == "bfloat16"
    assert got["mesh_shape"] == "data"
    assert got == want
    assert got["checkpoint_path"] == "save/x" and got["gpus"] == [0, 1]
    # --dtype is a flag of both; with JAX's value the namespaces agree
    ns_t = vars(tconfig.transfer_args(tconfig.parse_opt(
        ARGV + ["--dtype", "bfloat16"])))
    ns_j = vars(jconfig.transfer_args(jconfig.parse_opt(ARGV)))
    assert {k: v for k, v in ns_t.items() if k in ns_j} == {
        k: v for k, v in ns_j.items() if k in ns_t}
    assert ns_t["optim"] == "sgd" and ns_t["src_vocab_size"] == 0


def test_merge_checkpoint_config_matches_jax():
    from unpaired_image_captioning_tpu import config as jconfig

    for mod in (tconfig, jconfig):
        saved = mod.Config(caption_model="denseatt", rnn_size=64,
                           input_json="saved.json", beam_size=1)
        cli = mod.Config(beam_size=3, input_json="cli.json", max_epochs=7)
        out = mod.merge_checkpoint_config(cli, saved)
        assert (out.rnn_size, out.beam_size, out.input_json,
                out.max_epochs) == (64, 3, "cli.json", 40)
        with pytest.raises(ValueError, match="rnn_size"):
            mod.merge_checkpoint_config(mod.Config(rnn_size=32), saved)
    assert "device" in tconfig.EVAL_OVERRIDE_KEYS


def _optim_cfg():
    return tconfig.Config(i2t_optim="adam", nmt_optim="sgdm",
                          i2t_weight_decay=0.1, nmt_max_grad_norm=1.0)


def test_optimizer_state_round_trips_weights_only(tmp_path):
    from unpaired_image_captioning_tpu.train.optimizer import (
        DualOptim as JDualOptim)

    gen = torch.Generator().manual_seed(0)
    params = {"a": torch.randn(3, 4, generator=gen),
              "b": torch.randn(5, generator=gen)}
    grads = {k: torch.randn(p.shape, generator=gen)
             for k, p in params.items()}
    opt = DualOptim(_optim_cfg(), params, params)
    opt.i2t_state = opt.i2t_tx.update(grads, opt.i2t_state, params)[1]
    opt.nmt_state = opt.nmt_tx.update(grads, opt.nmt_state, params)[1]
    opt.nmt_step, opt.i2t_base_lr = 3, 0.25
    path = str(tmp_path / "optimizer.pt")
    tckpt.save_state(path, opt.state_dict())
    back = DualOptim(_optim_cfg(), params, params)
    back.load_state_dict(tckpt.load_state(path))
    assert set(opt.state_dict()) == set(JDualOptim(_optim_cfg()).state_dict())
    assert (back.nmt_step, back.i2t_base_lr) == (3, 0.25)
    for side in ("i2t", "nmt"):
        tx = getattr(opt, f"{side}_tx")
        u1, s1 = tx.update(grads, getattr(opt, f"{side}_state"), params)
        u2, s2 = tx.update(grads, getattr(back, f"{side}_state"), params)
        for k in u1:
            assert torch.equal(u1[k], u2[k])
    # the loaded tensors are copies, not the saved ones
    mu = [next(part["mu"]["a"] for part in o.i2t_state if "mu" in part)
          for o in (back, opt)]
    assert mu[0].data_ptr() != mu[1].data_ptr()


def test_plateau_scheduler_state_matches_jax():
    from unpaired_image_captioning_tpu.train.optimizer import (
        PlateauScheduler as JPlateau)

    metrics = [1.0, 2.0, 1.5, 1.5, 1.2, 1.1, 3.0, 2.0]
    t, j = PlateauScheduler(patience=1), JPlateau(patience=1)
    for m in metrics[:4]:
        assert t.update(m) == j.update(m)
    resumed = PlateauScheduler(patience=1)
    resumed.load_state_dict(json.loads(json.dumps(t.state_dict())))
    for m in metrics[4:]:
        assert resumed.update(m) == j.update(m)


def test_checkpoint_files_and_best_track(tmp_path):
    ckpt = tckpt.CheckpointManager(str(tmp_path / "run"))
    assert not ckpt.has_checkpoint() and not os.path.exists(ckpt.dir)
    state = {"w": torch.arange(6.0).reshape(2, 3)}
    ckpt.save(i2t_state=state, infos={"iter": 1}, histories={"h": 1})
    ckpt.save(i2t_state={"w": state["w"] + 1}, infos={"iter": 2}, best=True)
    assert ckpt.has_checkpoint() and ckpt.has_checkpoint(best=True)
    assert ckpt.load_infos()["iter"] == 1
    assert ckpt.load_infos(best=True)["iter"] == 2
    assert torch.equal(ckpt.load_params("model_i2t")["w"], state["w"])
    assert torch.equal(ckpt.load_params("model_i2t", best=True)["w"],
                       state["w"] + 1)
    assert ckpt.load_histories() == {"h": 1}
    assert ckpt.load_histories(best=True) == {}
    assert sorted(os.listdir(ckpt.dir)) == [
        "histories.json", "infos-best.json", "infos.json",
        "model_i2t-best.pt", "model_i2t.pt"]


def test_metric_logger_matches_jax(tmp_path):
    from unpaired_image_captioning_tpu.train.logging import (
        MetricLogger as JLogger)

    for cls, d in ((MetricLogger, "t"), (JLogger, "j")):
        log = cls(str(tmp_path / d))
        log.add_scalars(3, {"loss": np.float32(1.5), "acc": 2})
        log.add_scalars(4, {"loss": 0.25})
    rows = []
    for d in ("t", "j"):
        with open(tmp_path / d / "events.jsonl") as f:
            rows.append([{k: v for k, v in json.loads(line).items()
                          if k != "time"} for line in f])
    assert rows[0] == rows[1] == [{"step": 3, "loss": 1.5, "acc": 2.0},
                                  {"step": 4, "loss": 0.25}]


def test_pretrained_word_vectors_match_jax(tmp_path):
    import jax

    from unpaired_image_captioning_tpu.models.nmt import NMTModel as JNMT

    cfg = tconfig.Config(nmt_src_vocab_size=9, nmt_tgt_vocab_size=7,
                         word_vec_size=6, rnn_size=8, layers=1,
                         nmt_train_flag=True)
    rs = np.random.RandomState(0)
    enc = str(tmp_path / "enc.npy")
    dec = str(tmp_path / "dec.npz")
    np.save(enc, rs.randn(9, 6).astype(np.float32))
    np.savez(dec, embedding=rs.randn(7, 6))
    jm = JNMT.from_config(cfg)
    jp = JNMT.load_pretrained_embeddings(
        jm.init_params(jax.random.PRNGKey(0)), enc_path=enc, dec_path=dec)
    tr = ttrainer.Trainer(tconfig.Config(**{
        **cfg.to_dict(), "pre_word_vecs_enc": enc, "pre_word_vecs_dec": dec}),
        device="cpu")
    np.testing.assert_array_equal(
        tr.nmt_model.src_embedding().detach().numpy(),
        np.asarray(jp["encoder"]["embeddings"]["word_lut"]))
    np.testing.assert_array_equal(
        tr.nmt_model.tgt_embedding().detach().numpy(),
        np.asarray(jp["decoder"]["embeddings"]["word_lut"]))
    np.save(enc, rs.randn(8, 6).astype(np.float32))
    with pytest.raises(ValueError, match="encoder pretrained embeddings"):
        tr.nmt_model.load_pretrained_embeddings(enc_path=enc)


@pytest.mark.parametrize("kind", ["rnn", "transformer"])
def test_nmt_config_rebuilds_the_model(tmp_path, kind):
    """`nmt_config.json` holds `model_type` and the NMT model's constructor
    arguments: they rebuild the model, `model_nmt.pt` loads into it, and
    the fields it shares with the JAX package's file agree."""
    import inspect

    from unpaired_image_captioning_tpu.models.nmt import NMTModel as JNMT
    from unpaired_image_captioning_tpu.models.nmt_transformer import (
        TransformerNMTModel as JTNMT)
    from unpaired_image_captioning_tpu_torch.models.nmt import NMTModel
    from unpaired_image_captioning_tpu_torch.models.nmt_transformer import (
        TransformerNMTModel)

    cfg = tconfig.Config(nmt_src_vocab_size=9, nmt_tgt_vocab_size=7,
                         word_vec_size=8, rnn_size=12, layers=2, num_heads=2,
                         nmt_model_type=kind, nmt_train_flag=True,
                         checkpoint_path=str(tmp_path / "run"))
    tr = ttrainer.Trainer(cfg, device="cpu")
    tr.save()
    saved = json.load(open(tmp_path / "run" / "nmt_config.json"))
    assert saved.pop("model_type") == kind
    cls, jcls = ((TransformerNMTModel, JTNMT) if kind == "transformer"
                 else (NMTModel, JNMT))
    assert isinstance(tr.nmt_model, cls)
    assert set(saved) == set(inspect.signature(cls).parameters) - {"device"}
    model = cls(**saved, device="cpu")
    model.load_state_dict(tr.ckpt.load_params("model_nmt", device="cpu"))
    for (k, p), (k2, q) in zip(tr.nmt_model.state_dict().items(),
                               model.state_dict().items()):
        assert k == k2 and torch.equal(p, q), k
    # as a JSON file holds them (a tuple field, src_feature_sizes, is a
    # list there)
    jax_fields = json.loads(json.dumps(dataclasses.asdict(
        jcls.from_config(cfg))))
    shared = set(saved) & set(jax_fields)
    assert {"src_vocab_size", "tgt_vocab_size", "dropout"} <= shared
    assert {k: saved[k] for k in shared} == {k: jax_fields[k]
                                             for k in shared}


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_trainer_save_load_round_trip(cuda_dev, tmp_path):
    """A joint denseatt + BiLSTM NMT trainer on the card: two steps, a
    checkpoint, two more steps; a second trainer loads the checkpoint and
    takes the same two steps to the same parameters bit for bit."""
    cfg = tconfig.Config(
        caption_model="denseatt", vocab_size=20, rnn_size=16, num_layers=1,
        input_encoding_size=16, att_hid_size=12, fc_feat_size=16,
        att_feat_size=16, seq_length=5, batch_size=3, seq_per_img=1,
        i2t_train_flag=True, nmt_train_flag=True, nmt_src_vocab_size=12,
        nmt_tgt_vocab_size=10, word_vec_size=16, layers=1, nmt_optim="adam",
        checkpoint_path=str(tmp_path / "run"))
    rs = np.random.RandomState(0)
    src, tgt = tsyn.make_nmt_corpus(n_pairs=3, src_vocab=12, tgt_vocab=10)

    def batch():
        labels = np.zeros((3, 7), np.int64)
        labels[:, 1:5] = rs.randint(1, 21, (3, 4))
        return {"fc_feats": rs.randn(3, 16).astype(np.float32),
                "att_feats": rs.randn(3, 4, 16).astype(np.float32),
                "att_masks": np.ones((3, 4), np.float32), "labels": labels,
                "masks": (labels > 0).astype(np.float32) + (
                    np.arange(7) < 1),
                "nmt": {"src": src, "tgt": tgt,
                        "lengths": (src > 0).sum(1)}}

    batches = [batch() for _ in range(4)]
    a = ttrainer.Trainer(cfg, device=cuda_dev)
    for b in batches[:2]:
        a.train(b)
    a.save()
    for b in batches[2:]:
        a.train(b)
    b_tr = ttrainer.Trainer(cfg, device=cuda_dev)
    assert b_tr.load()["iter"] == 2 and b_tr.iteration == 2
    for b in batches[2:]:
        b_tr.train(b)
    for x, y in ((a.i2t_model, b_tr.i2t_model), (a.nmt_model, b_tr.nmt_model)):
        for (k, p), (_, q) in zip(x.state_dict().items(),
                                  y.state_dict().items()):
            assert p.device.type == "cuda" and torch.equal(p, q), k
