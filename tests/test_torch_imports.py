"""Import hygiene and default device of the port.

No module of `unpaired_image_captioning_tpu_torch/`, and not
`chip_smoke.py`, may import jax or the JAX package
`unpaired_image_captioning_tpu` (the port keeps its own copies of the
host code it needs). Its entry points build on the card unless the caller
names another device, and raise rather than build on the CPU without one.
"""

import ast
from pathlib import Path

import pytest
import torch

from unpaired_image_captioning_tpu_torch import models as tmodels
from unpaired_image_captioning_tpu_torch.config import Config
from unpaired_image_captioning_tpu_torch.data.raw_images import RawImageLoader
from unpaired_image_captioning_tpu_torch.models import base
from unpaired_image_captioning_tpu_torch.models.nmt import NMTModel
from unpaired_image_captioning_tpu_torch.models.nmt_transformer import (
    TransformerNMTModel, make_nmt_model)
from unpaired_image_captioning_tpu_torch.models.resnet import ResNet
from unpaired_image_captioning_tpu_torch.ops import cider
from unpaired_image_captioning_tpu_torch.scripts import (prepro_feats,
                                                         prepro_ngrams)
from unpaired_image_captioning_tpu_torch.train.trainer import Trainer

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "unpaired_image_captioning_tpu_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]
CFG = dict(caption_model="transformer", vocab_size=5, input_encoding_size=8,
           rnn_size=8, num_layers=1, num_heads=2, fc_feat_size=4,
           att_feat_size=4, seq_length=3, nmt_src_vocab_size=6,
           nmt_tgt_vocab_size=7, word_vec_size=8, layers=1)


def _imported(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.name)
def test_no_jax_imports(path):
    for name in _imported(path):
        top = name.split(".")[0]
        assert top != "jax", f"{path} imports {name}"
        assert top != "unpaired_image_captioning_tpu", f"{path} imports {name}"


@pytest.mark.parametrize("build", [
    lambda cfg: tmodels.setup(cfg),
    lambda cfg: make_nmt_model(cfg),
    lambda cfg: TransformerNMTModel.from_config(cfg),
    lambda cfg: NMTModel.from_config(cfg),
], ids=["setup", "make_nmt_model", "transformer_nmt", "nmt"])
def test_entry_points_default_to_the_card(build, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build(Config(**CFG))
    model = tmodels.setup(Config(**CFG), device="cpu")
    assert model.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert base.resolve_device() == torch.device("cuda")


@pytest.mark.parametrize("build", [
    lambda dev: ResNet("resnet_tiny", **dev),
    lambda dev: RawImageLoader(folder_path=".", depth="resnet_tiny", **dev),
], ids=["resnet", "raw_image_loader"])
def test_raw_image_path_defaults_to_the_card(build, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build({})
    assert build({"device": "cpu"}).device.type == "cpu"


def test_scst_modules_are_checked():
    """The SCST modules are among the files the import check reads."""
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert {f"unpaired_image_captioning_tpu_torch/{m}.py" for m in (
        "ops/cider", "losses/rewards", "scripts/prepro_ngrams",
        "train/trainer")} <= names


def test_training_cli_modules_are_checked():
    """The training CLI's modules are among the files the import check
    reads, and each imports without a card."""
    import importlib

    mods = ("cli/train", "config", "data/arrays", "data/dataloader",
            "data/nmt_dataset", "data/synthetic", "eval/eval_utils",
            "eval/metrics/__init__", "eval/metrics/bleu",
            "eval/metrics/cider", "eval/metrics/meteor",
            "eval/metrics/meteor_data", "eval/metrics/porter",
            "eval/metrics/rouge", "eval/metrics/spice", "eval/metrics/ter",
            "native", "scripts/h5_to_npz", "scripts/prepro_split_tokenize",
            "train/checkpoint", "train/logging", "train/optimizer")
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert {f"unpaired_image_captioning_tpu_torch/{m}.py"
            for m in mods} <= names
    for m in mods:
        importlib.import_module("unpaired_image_captioning_tpu_torch."
                                + m.replace("/", ".").replace(".__init__", ""))


def test_eval_and_migration_modules_are_checked():
    """The eval CLIs, the feature workers and the migration's modules are
    among the files the import check reads, and each imports without a
    card."""
    import importlib

    mods = ("cli/eval_paired", "cli/eval_pivot", "cli/eval_unpaired",
            "cli/translate", "data/prefetch", "models/convert", "pivot",
            "scripts/migrate_reference", "utils/text")
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert {f"unpaired_image_captioning_tpu_torch/{m}.py"
            for m in mods} <= names
    for m in mods:
        importlib.import_module("unpaired_image_captioning_tpu_torch."
                                + m.replace("/", "."))


@pytest.mark.parametrize("cli", ["eval_unpaired", "eval_pivot",
                                 "eval_paired", "translate", "eval_30k"])
def test_eval_clis_default_to_the_card(cli, monkeypatch, tmp_path):
    """Each eval CLI (and eval_30k's online route through translate) builds
    on the card unless `--device` / `-device` names another, and raises
    without one before it reads any model."""
    import importlib
    import json

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    (tmp_path / "infos-best.json").write_text(json.dumps({"opt": {}}))
    (tmp_path / "caps.txt").write_text("w1 w2\n")
    argv = {"translate": ["-model", str(tmp_path), "-src", "caps.txt"],
            "eval_30k": ["--eval_30k", "caps.txt", "--eval_30k_mode",
                         "online", "--start_from", str(tmp_path)]}.get(
        cli, ["--start_from", str(tmp_path)])
    mod = importlib.import_module("unpaired_image_captioning_tpu_torch.cli."
                                  + ("eval_unpaired" if cli == "eval_30k"
                                     else cli))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(argv)


@pytest.mark.parametrize("build", [
    lambda dev: cider.build_df_table({(1, 2): 1.0}, 2.0, **dev),
    lambda dev: cider.empty_df_table(**dev),
    lambda dev: prepro_ngrams.load_df_table("absent", **dev),
    lambda dev: Trainer(Config(**CFG), **dev),
], ids=["build_df_table", "empty_df_table", "load_df_table", "trainer"])
def test_scst_entry_points_default_to_the_card(build, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build({})
    build({"device": "cpu"})


def test_prepro_feats_defaults_to_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    listing = tmp_path / "images.json"
    listing.write_text('{"images": []}')
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prepro_feats.main(["--input_json", str(listing), "--output_dir",
                           str(tmp_path / "f"), "--model", "resnet_tiny"])



@pytest.mark.parametrize("args,code", [([], 1), (["--times", "topk,mha"], 1),
                                       (["--times", "lstm"], 2)])
def test_chip_smoke_prints_no_result_without_a_card(args, code):
    """`chip_smoke.py` exits non-zero with nothing on stdout where CUDA is
    not available (and on a `--times` group it does not know), before it
    builds or runs anything."""
    import os
    import subprocess
    import sys

    run = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py"), *args], cwd=ROOT,
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert run.returncode == code, run.stderr
    assert run.stdout == ""


def test_preprocessing_modules_are_checked():
    """The preprocessing scripts, the utils and the preprocess CLI are
    among the files the import check reads, and each imports without a
    card."""
    import importlib

    mods = ("cli/preprocess", "scripts/make_bu_data",
            "scripts/prepro_backtranslate", "scripts/prepro_json2text",
            "scripts/prepro_labels", "scripts/prepro_reference_json",
            "scripts/prepro_split_tokenize", "utils/bpe", "utils/report",
            "utils/vis_words", "utils/word_cloud")
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert {f"unpaired_image_captioning_tpu_torch/{m}.py"
            for m in mods} <= names
    for m in mods:
        importlib.import_module("unpaired_image_captioning_tpu_torch."
                                + m.replace("/", "."))


def test_port_has_a_file_for_each_jax_module_but_the_queued_ones():
    """Every module of the JAX package has the port's counterpart: no queue
    item of modules is open since A12 and A14 landed."""
    queued = set()

    def listing(pkg):
        base = ROOT / pkg
        return {p.relative_to(base).as_posix() for p in base.rglob("*.py")}

    missing = listing("unpaired_image_captioning_tpu") - listing(
        "unpaired_image_captioning_tpu_torch")
    assert missing == queued


def test_backtranslate_defaults_to_the_card(monkeypatch, tmp_path):
    from unpaired_image_captioning_tpu_torch.scripts import (
        prepro_backtranslate)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (tmp_path / "zh.txt").write_text("w1 w2\n")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prepro_backtranslate.main(["--input", str(tmp_path / "zh.txt"),
                                   "--output", str(tmp_path / "en.txt"),
                                   "--nmt_run", str(tmp_path)])


def test_eval_ensemble_defaults_to_the_card(monkeypatch, tmp_path):
    from unpaired_image_captioning_tpu_torch.cli import eval_ensemble

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eval_ensemble.main(["--ids", str(tmp_path)])


def test_scale_out_and_fork_modules_are_checked():
    """The fork transformer and the scale-out modules are among the files
    the import check reads, and each imports without a card."""
    import importlib

    mods = ("models/fork_transformer", "parallel/__init__", "parallel/mesh",
            "parallel/launch", "parallel/dryrun")
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert {f"unpaired_image_captioning_tpu_torch/{m}.py"
            for m in mods} <= names
    for m in mods:
        importlib.import_module("unpaired_image_captioning_tpu_torch."
                                + m.replace("/", ".").replace(".__init__", ""))


@pytest.mark.parametrize("build", [
    lambda dev: __import__(
        "unpaired_image_captioning_tpu_torch.models.fork_transformer",
        fromlist=["x"]).ForkTransformerNMT(11, 13, d_model=8, d_inner=8,
                                           num_layers=1, num_heads=2, **dev),
    lambda dev: __import__(
        "unpaired_image_captioning_tpu_torch.parallel.launch",
        fromlist=["x"]).num_ranks(2, **{"device": "cuda", **dev}),
], ids=["fork_transformer", "num_ranks"])
def test_fork_and_scale_out_default_to_the_card(build, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build({})
    build({"device": "cpu"})


@pytest.mark.parametrize("cli", ["train", "eval_paired", "dryrun"])
def test_scale_out_entry_points_default_to_the_card(cli, monkeypatch,
                                                    tmp_path):
    """`cli.train --num_devices 2`, `cli.eval_paired --num_devices 2` and
    `dryrun_multichip(2)` start their ranks on the cards unless the caller
    names the CPU, and raise without a card before any rank starts."""
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    if cli == "dryrun":
        from unpaired_image_captioning_tpu_torch.parallel.dryrun import (
            dryrun_multichip)

        with pytest.raises(RuntimeError, match="no CUDA device"):
            dryrun_multichip(2)
        return
    mod = importlib.import_module("unpaired_image_captioning_tpu_torch.cli."
                                  + cli)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(["--num_devices", "2", "--start_from", str(tmp_path),
                  "--checkpoint_path", str(tmp_path)])
