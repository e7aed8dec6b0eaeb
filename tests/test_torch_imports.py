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
