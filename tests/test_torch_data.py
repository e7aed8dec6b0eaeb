"""The port's data layer (`data/dataloader.py`, `data/nmt_dataset.py`,
`data/synthetic.py`, `data/arrays.py`, `scripts/h5_to_npz.py`) against the
JAX package's on the same artifacts.

`CaptionDataLoader.get_batch` gives every key equal to JAX's, across two
epoch wraps of the training split, with and without an attached NMT
dataset, with the box / norm / cls-prob attributes and from feature
directories; `NMTDataset.next_batch` equals JAX's under shuffle,
curriculum and batch shuffle. A `state_dict` round trip (through JSON)
resumes with the same next batches. The `.npz` label and corpus files that
`h5_to_npz` writes give the same batches as the `.h5` files, and the port's
synthetic artifacts equal JAX's.
"""

import json
import os
import sys

import numpy as np
import pytest

from unpaired_image_captioning_tpu_torch.data import synthetic as tsyn
from unpaired_image_captioning_tpu_torch.data.arrays import read_arrays
from unpaired_image_captioning_tpu_torch.data.dataloader import (
    CaptionDataLoader)
from unpaired_image_captioning_tpu_torch.data.nmt_dataset import NMTDataset
from unpaired_image_captioning_tpu_torch.scripts import h5_to_npz

N_BATCHES = 7   # 8 train images at batch 3: wraps at batches 3 and 6
KW = dict(batch_size=3, seq_per_img=2, att_feat_size=24, attri_feat_size=16,
          seed=11)
OPTIONS = {"plain": {},
           "box_norm_cls": dict(use_box=1, norm_att_feat=1, norm_box_feat=1,
                                use_box_cls_prob=1)}


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """The JAX package's synthetic artifacts (label.h5) and their .npz
    conversion, the features also written as directories."""
    from unpaired_image_captioning_tpu.data.synthetic import (
        make_caption_artifacts, make_nmt_corpus)

    tmp = tmp_path_factory.mktemp("data")
    jpath, h5path, mem = make_caption_artifacts(str(tmp), seed=3)
    npz = h5_to_npz.main([h5path])
    fc_dir, att_dir = tsyn.write_feature_dirs(str(tmp), mem)
    src, tgt = make_nmt_corpus(n_pairs=20, seed=4)
    return dict(tmp=tmp, json=jpath, h5=h5path, npz=npz, mem=mem,
                fc_dir=fc_dir, att_dir=att_dir, src=src, tgt=tgt)


def _same(a, b, where=""):
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == np.asarray(b).dtype, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, where


def _batches(loader, n, split="train"):
    return [loader.get_batch(split) for _ in range(n)]


@pytest.mark.parametrize("nmt", [False, True], ids=["alone", "with_nmt"])
@pytest.mark.parametrize("option", list(OPTIONS))
def test_get_batch_matches_jax(artifacts, option, nmt):
    from unpaired_image_captioning_tpu.data.dataloader import (
        CaptionDataLoader as JLoader)
    from unpaired_image_captioning_tpu.data.nmt_dataset import (
        NMTDataset as JNMT)

    a = artifacts
    kw = dict(KW, **OPTIONS[option])
    nmt_kw = dict(shuffle=True, seed=5)
    jl = JLoader(input_json=a["json"], input_label_h5=a["h5"],
                 in_memory=a["mem"], **kw,
                 nmt_dataset=JNMT(a["src"], a["tgt"], 3, **nmt_kw)
                 if nmt else None)
    tl = CaptionDataLoader(input_json=a["json"], input_label_h5=a["h5"],
                           in_memory=a["mem"], **kw,
                           nmt_dataset=NMTDataset(a["src"], a["tgt"], 3,
                                                  **nmt_kw) if nmt else None)
    got, want = _batches(tl, N_BATCHES), _batches(jl, N_BATCHES)
    assert sum(b["bounds"]["wrapped"] for b in want) == 2
    _same(got, want)
    # the val split, as eval_split reads it
    _same(_batches(tl, 2, "val"), _batches(jl, 2, "val"))
    assert tl.vocab.ix_to_word == jl.vocab.ix_to_word


def test_feature_directories_match_jax(artifacts):
    from unpaired_image_captioning_tpu.data.dataloader import (
        CaptionDataLoader as JLoader)

    a = artifacts
    kw = dict(KW, input_fc_dir=a["fc_dir"], input_att_dir=a["att_dir"])
    tl = CaptionDataLoader(input_json=a["json"], input_label_h5=a["npz"],
                           **kw)
    jl = JLoader(input_json=a["json"], input_label_h5=a["h5"], **kw)
    _same(_batches(tl, 4), _batches(jl, 4))


@pytest.mark.parametrize("kw", [dict(shuffle=True),
                                dict(shuffle=True, curriculum=2),
                                dict(batch_shuffle=True)],
                         ids=["shuffle", "curriculum", "batch_shuffle"])
def test_nmt_dataset_matches_jax(artifacts, kw):
    from unpaired_image_captioning_tpu.data.nmt_dataset import (
        NMTDataset as JNMT)

    a = artifacts
    jd = JNMT(a["src"], a["tgt"], 6, seed=9, **kw)
    td = NMTDataset(a["src"], a["tgt"], 6, seed=9, **kw)
    assert len(td) == len(jd) == 4
    for _ in range(14):
        _same(td.next_batch(), jd.next_batch())
    _same(td.state_dict(), jd.state_dict())


def test_state_dict_resumes_the_same_batches(artifacts):
    a = artifacts

    def make():
        return CaptionDataLoader(
            input_json=a["json"], input_label_h5=a["npz"], in_memory=a["mem"],
            **KW, nmt_dataset=NMTDataset(a["src"], a["tgt"], 3, shuffle=True,
                                         seed=5))

    first = make()
    _batches(first, 4)
    state = json.loads(json.dumps(first.state_dict()))
    after = _batches(first, 5)
    resumed = make()
    resumed.load_state_dict(state)
    _same(_batches(resumed, 5), after)


def test_npz_route_equals_h5_route(artifacts, tmp_path):
    a = artifacts
    _same(read_arrays(a["npz"]), read_arrays(a["h5"]))
    loaders = [CaptionDataLoader(input_json=a["json"], input_label_h5=p,
                                 in_memory=a["mem"], **KW)
               for p in (a["h5"], a["npz"])]
    _same(*[_batches(ld, N_BATCHES) for ld in loaders])
    # the NMT corpus both ways, with a source-feature stream
    import h5py

    h5 = str(tmp_path / "nmt.train.h5")
    with h5py.File(h5, "w") as f:
        f["src"], f["tgt"] = a["src"], a["tgt"]
        f["src_feat_0"] = a["src"] % 3
    npz = h5_to_npz.main([h5, "--output", str(tmp_path / "corpus.npz")])
    sets = [NMTDataset.from_h5(p, 4, shuffle=True, seed=2) for p in (h5, npz)]
    for _ in range(6):
        _same(sets[0].next_batch(), sets[1].next_batch())
    assert "src_feats" in sets[1].next_batch()[0]


def test_synthetic_artifacts_equal_jax(tmp_path):
    from unpaired_image_captioning_tpu.data import synthetic as jsyn

    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jj, jh5, jmem = jsyn.make_caption_artifacts(str(tmp_path / "jax"),
                                                seed=2)
    tj, tnpz, tmem = tsyn.make_caption_artifacts(str(tmp_path / "port"),
                                                 seed=2)
    assert tnpz.endswith(".npz")
    assert json.load(open(jj)) == json.load(open(tj))
    _same(read_arrays(tnpz), read_arrays(jh5))
    _same(tmem, jmem)
    _same(tsyn.make_nmt_corpus(seed=6), jsyn.make_nmt_corpus(seed=6))
    # more val and test images: the last n_val + n_test
    tj2, _, _ = tsyn.make_caption_artifacts(str(tmp_path / "port"),
                                            n_images=9, n_val=3, n_test=1)
    splits = [im["split"] for im in json.load(open(tj2))["images"]]
    assert splits == ["train"] * 5 + ["val"] * 3 + ["test"]


def test_h5_without_h5py_names_the_npz_route(artifacts, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5_to_npz"):
        read_arrays(artifacts["h5"])
    assert set(read_arrays(artifacts["npz"])) >= {"labels", "label_start_ix"}


def test_bfloat16_features_name_the_compute_dtype(artifacts):
    """feat_dtype="bfloat16" (the compute dtype's loader option) gives the
    f32 loader's features rounded to bf16 as CPU bf16 tensors, the other
    keys unchanged; any other feat_dtype raises, naming the two it takes."""
    import torch

    a = artifacts
    f32 = CaptionDataLoader(input_json=a["json"], input_label_h5=a["npz"],
                            in_memory=a["mem"], **KW).get_batch("train")
    bf = CaptionDataLoader(input_json=a["json"], input_label_h5=a["npz"],
                           in_memory=a["mem"], feat_dtype="bfloat16",
                           **KW).get_batch("train")
    for k in ("fc_feats", "att_feats", "attri_feats"):
        assert bf[k].dtype == torch.bfloat16
        assert torch.equal(bf[k], torch.from_numpy(f32[k]).to(torch.bfloat16))
    for k in ("att_masks", "labels", "masks", "gts"):
        np.testing.assert_array_equal(bf[k], f32[k])
    with pytest.raises(ValueError, match="bfloat16"):
        CaptionDataLoader(input_json=a["json"], input_label_h5=a["npz"],
                          feat_dtype="float16")


def test_references_are_the_decoded_captions(artifacts):
    a = artifacts
    ld = CaptionDataLoader(input_json=a["json"], input_label_h5=a["npz"],
                           in_memory=a["mem"], **KW)
    refs = ld.references("val")
    assert sorted(refs) == [8, 9]
    arrays = read_arrays(a["npz"])
    s, e = arrays["label_start_ix"][8], arrays["label_end_ix"][8]
    assert refs[8] == ld.vocab.decode_sequence(arrays["labels"][s - 1:e])
    assert os.path.exists(a["npz"])
