"""The port's feature workers (`data/prefetch.py`, the loader's
`FeatureReader` and its pickled copy, `cli/train.py --input_workers`) on the
CPU.

- `ThreadPrefetcher` and `ProcessPrefetcher` yield exactly the stream of
  synchronous `get_batch`, bit for bit, across epoch wraps and with an
  attached NMT corpus, with features read from directories and from one
  `.npz` / HDF5 file each (the workers reopen the HDF5 handles).
- A loader of one data rank (`data_rank` of `num_data_ranks`) yields its
  block of the global training stream and reads only that block's
  images, with and without the workers; its eval splits stay global.
- `ProcessPrefetcher.state_dict()` after k `get()`s, loaded into a fresh
  loader, reproduces the rest of the stream; after `rewind()`, a reader of
  the loader in between draws what it draws without workers, and the
  workers skip the dropped batches they have not started.
- `cli.train.main` with `--input_workers 2` ends with the parameters and
  optimizer state of the same run with 0, bit for bit, and checkpoints the
  same loader state.

On the card (`cuda`, skipped here): an epoch of a CUDA trainer fed by
`--input_workers 2` equals the run without workers.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from unpaired_image_captioning_tpu_torch import constants as C
from unpaired_image_captioning_tpu_torch.cli import train as tcli
from unpaired_image_captioning_tpu_torch.data import synthetic as tsyn
from unpaired_image_captioning_tpu_torch.data.dataloader import (
    CaptionDataLoader)
from unpaired_image_captioning_tpu_torch.data.nmt_dataset import NMTDataset
from unpaired_image_captioning_tpu_torch.data.prefetch import (
    ProcessPrefetcher, ThreadPrefetcher)
from unpaired_image_captioning_tpu_torch.vocab import Dict

torch.set_num_threads(1)
ZH_V = 20
N_BATCHES = 7            # 10 train images at batch 3: two epoch wraps


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorflow", None)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Caption artifacts with features as directories and as one .npz file
    each (and .h5, written on first use: the card's machine has no h5py),
    a zh->en corpus and its dicts."""
    tmp = tmp_path_factory.mktemp("prefetch")
    jpath, npz, mem = tsyn.make_caption_artifacts(
        str(tmp), n_images=14, vocab_size=ZH_V, seq_length=5,
        caps_per_img=2, seed=4)
    fc_dir, att_dir = tsyn.write_feature_dirs(str(tmp), mem)
    ids = sorted(mem["fc"], key=int)
    fc = np.stack([mem["fc"][i] for i in ids])
    att = np.stack([mem["att"][i] for i in ids])
    np.savez(str(tmp / "fc.npz"), fc=fc)
    np.savez(str(tmp / "att.npz"), att=att)
    src, tgt = tsyn.make_nmt_corpus(n_pairs=40, src_vocab=ZH_V + 4,
                                    tgt_vocab=30, seed=6)
    nmt = str(tmp / "nmt.train.npz")
    np.savez(nmt, src=src, tgt=tgt)
    specials = [C.PAD_WORD, C.UNK_WORD, C.BOS_WORD, C.EOS_WORD]
    dicts = str(tmp / "dicts.json")
    with open(dicts, "w") as f:
        json.dump({"src": Dict(specials + [f"w{i}" for i in range(ZH_V)])
                   .state_dict(),
                   "tgt": Dict(specials + [f"t{i}" for i in range(26)])
                   .state_dict()}, f)
    return dict(tmp=tmp, json=jpath, label=npz, fc_dir=fc_dir,
                att_dir=att_dir, nmt=nmt, dicts=dicts, src=src, tgt=tgt)


FEATURES = {"dirs": ("fc_dir", "att_dir"), "npz": ("fc.npz", "att.npz"),
            "h5": ("fc.h5", "att.h5")}


def _loader(f, features="dirs", **block):
    fc, att = FEATURES[features]
    if features == "h5" and not (f["tmp"] / fc).exists():
        import h5py

        for name in ("fc", "att"):
            with h5py.File(str(f["tmp"] / f"{name}.h5"), "w") as h5, \
                    np.load(str(f["tmp"] / f"{name}.npz")) as blob:
                h5[name] = blob[name]
    kw = (dict(input_fc_dir=f[fc], input_att_dir=f[att])
          if features == "dirs" else
          dict(input_fc_h5=str(f["tmp"] / fc),
               input_att_h5=str(f["tmp"] / att)))
    return CaptionDataLoader(
        input_json=f["json"], input_label_h5=f["label"], batch_size=3,
        seq_per_img=2, att_feat_size=24, seed=7,
        nmt_dataset=NMTDataset(f["src"], f["tgt"], 4, shuffle=True, seed=2),
        **kw, **block)


def _same_batch(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, k
            np.testing.assert_array_equal(g, w, err_msg=k)
        elif k == "nmt":
            _same_batch(g, w)
        else:
            assert g == w, k


def _stream(loader, n=N_BATCHES):
    return [loader.get_batch("train") for _ in range(n)]


@pytest.mark.parametrize("features", sorted(FEATURES))
def test_process_prefetcher_is_the_synchronous_stream(files, features):
    want = _stream(_loader(files, features))
    pf = ProcessPrefetcher(_loader(files, features), "train", num_workers=2,
                           depth=3)
    try:
        # the batches own their arrays: hold them all, then compare
        got = [pf.get() for _ in want]
    finally:
        pf.close()
    for g, w in zip(got, want):
        _same_batch(g, w)


def test_thread_prefetcher_is_the_synchronous_stream(files):
    want = _stream(_loader(files))
    loader = _loader(files)
    pf = ThreadPrefetcher(lambda: loader.get_batch("train"), depth=2)
    try:
        for w in want:
            _same_batch(pf.get(), w)
    finally:
        pf.close()


@pytest.mark.parametrize("k", [0, 3, 5])
def test_state_dict_resumes_the_stream(files, k):
    want = _stream(_loader(files))
    pf = ProcessPrefetcher(_loader(files), "train", num_workers=2, depth=4)
    try:
        for _ in range(k):
            pf.get()
        state = json.loads(json.dumps(pf.state_dict()))
    finally:
        pf.close()
    fresh = _loader(files)
    fresh.load_state_dict(state)
    for w in want[k:]:
        _same_batch(fresh.get_batch("train"), w)


def _block_of(batch, parts, r, spi=2):
    """Data rank r's block of a global batch, as `parallel.shard_batch`
    cuts it (every array's rows, the NMT batch's too), with the infos of
    the images those rows come from."""
    from unpaired_image_captioning_tpu_torch.parallel.mesh import (
        block_bounds)

    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            lo, hi = block_bounds(len(v), parts, r)
            out[k] = v[lo:hi]
        elif k == "nmt":
            out[k] = _block_of(v, parts, r, spi)
        else:
            out[k] = v
    if "infos" in batch:
        lo, hi = block_bounds(len(batch["labels"]), parts, r)
        out["infos"] = batch["infos"][lo // spi:(hi + spi - 1) // spi]
    return out


@pytest.mark.parametrize("parts", [2, 3, 4])
def test_data_rank_reads_its_block_of_the_global_stream(files, parts):
    """A loader built with `data_rank` r of `num_data_ranks` yields, batch
    by batch, rank r's block of the global training stream (3 images x 2
    captions: blocks that split an image's rows, and uneven ones), and
    reads only the images of that block."""
    glob = _loader(files)
    want = _stream(glob)
    want_val = glob.get_batch("val")
    for r in range(parts):
        loader = _loader(files, data_rank=r, num_data_ranks=parts)
        read = []
        gather = loader.features.gather
        loader.features.gather = lambda ixs: (read.append(list(ixs))
                                              or gather(ixs))
        for w in want:
            g = loader.get_batch("train")
            _same_batch(g, _block_of(w, parts, r))
            assert read[-1] == [i["ix"] for i in g["infos"]]
            assert len(read[-1]) < 3
        # the eval splits stay global
        _same_batch(loader.get_batch("val"), want_val)


def test_process_prefetcher_reads_a_data_rank_block(files):
    """The feature workers give a data rank's loader the same block
    stream as its synchronous reads."""
    want = _stream(_loader(files, data_rank=1, num_data_ranks=2))
    pf = ProcessPrefetcher(_loader(files, data_rank=1, num_data_ranks=2),
                           "train", num_workers=2, depth=3)
    try:
        got = [pf.get() for _ in want]
    finally:
        pf.close()
    for g, w in zip(got, want):
        _same_batch(g, w)


def test_pickled_reader_leaves_out_handles(files):
    """What a worker receives, the loader's FeatureReader: no HDF5 handle
    (the npz arrays travel), and `reopen` brings the handles back;
    `gather`, replicated, is `assemble_features`. The loader's own pickle
    keeps its NMT corpus."""
    import pickle

    h5 = pickle.loads(pickle.dumps(_loader(files, "h5").features))
    assert h5._fc_h5 is None and h5._att_h5 is None
    h5.reopen()
    npz = pickle.loads(pickle.dumps(_loader(files, "npz").features))
    assert isinstance(npz._fc_h5, np.ndarray)
    loader = _loader(files)
    want = loader.assemble_features([0, 3])
    for reader in (h5, npz):
        _same_batch(loader.replicate(reader.gather([0, 3])), want)
    copy = pickle.loads(pickle.dumps(loader))
    assert copy.nmt is not None
    _same_batch(copy.get_batch("train"), loader.get_batch("train"))


def _argv(f, run, device="cpu", **kw):
    base = {
        "caption_model": "denseatt", "input_json": f["json"],
        "input_label_h5": f["label"], "input_fc_dir": f["fc_dir"],
        "input_att_dir": f["att_dir"], "i2t_train_flag": "true",
        "nmt_train_flag": "true", "input_nmt_h5": f["nmt"],
        "input_nmt_dict": f["dicts"], "batch_size": "3", "seq_per_img": "2",
        "rnn_size": "16", "input_encoding_size": "16", "att_hid_size": "12",
        "fc_feat_size": "32", "att_feat_size": "24", "num_layers": "1",
        "word_vec_size": "16", "layers": "1", "drop_prob_lm": "0.1",
        "dropout": "0.1", "max_epochs": "2", "losses_log_every": "1",
        "save_checkpoint_every": "1000", "checkpoint_path": run,
        "id": os.path.basename(run), "device": device,
    }
    base.update({k: str(v) for k, v in kw.items()})
    return [x for k, v in base.items() for x in ("--" + k, v)]


def _state(trainer):
    out = {f"i2t.{k}": v for k, v in trainer.i2t_model.state_dict().items()}
    out.update({f"nmt.{k}": v
                for k, v in trainer.nmt_model.state_dict().items()})
    for side in ("i2t_state", "nmt_state"):
        for i, part in enumerate(trainer.optim.state_dict()[side]):
            for field, v in part.items():
                for name, x in (v.items() if isinstance(v, dict)
                                else [("", v)]):
                    out[f"{side}.{i}.{field}.{name}"] = x
    return out


def _same_state(a, b):
    sa, sb = _state(a), _state(b)
    assert sorted(sa) == sorted(sb)
    for k in sa:
        x, y = sa[k], sb[k]
        assert (torch.equal(x, y) if isinstance(x, torch.Tensor)
                else x == y), k


def test_rewind_gives_the_loader_back(files):
    """Batches planned ahead, then rewind(), a val batch read from the
    loader (its caption draws and NMT batch) and train batches again: the
    stream of synchronous reads in that order."""
    sync = _loader(files)
    want = [sync.get_batch("train") for _ in range(2)]
    want_val = sync.get_batch("val")
    want += [sync.get_batch("train") for _ in range(3)]
    loader = _loader(files)
    pf = ProcessPrefetcher(loader, "train", num_workers=2, depth=4)
    try:
        got = [pf.get() for _ in range(2)]
        pf.rewind()
        _same_batch(loader.get_batch("val"), want_val)
        got += [pf.get() for _ in range(3)]
    finally:
        pf.close()
    for g, w in zip(got, want):
        _same_batch(g, w)


def test_rewind_skips_the_dropped_tasks(files):
    """rewind() at once, before the workers have started: they read none
    of the dropped batches, and the stream is still the synchronous one."""
    want = _stream(_loader(files), 3)
    pf = ProcessPrefetcher(_loader(files), "train", num_workers=2, depth=6)
    try:
        pf.rewind()
        got = [pf.get() for _ in want]
        # the dropped tasks come back unread: the workers take their first
        # task after rewind() has returned (each imports numpy and the
        # package first); only a worker scheduled first could read one
        while pf._stale:
            pf._recv()
        assert pf.skipped > 0
    finally:
        pf.close()
    for g, w in zip(got, want):
        _same_batch(g, w)


def test_cli_with_workers_equals_without(files, tmp_path, monkeypatch):
    """Dropout on, two epochs of the joint recipe with an eval every 3
    steps (which draws from the loader too): the workers change nothing in
    the run, and the checkpoints hold the same loader state."""
    monkeypatch.chdir(tmp_path)
    runs = {n: str(tmp_path / f"w{n}") for n in (0, 2)}
    trainers = {n: tcli.main(_argv(files, run, input_workers=n,
                                   save_checkpoint_every=3))
                for n, run in runs.items()}
    assert trainers[0].iteration == trainers[2].iteration > 3
    _same_state(trainers[0], trainers[2])
    infos = [json.load(open(os.path.join(run, "infos.json")))
             for run in runs.values()]
    assert infos[0]["loader_state"] == infos[1]["loader_state"]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_trainer_with_workers_equals_without(cuda_dev, files, tmp_path,
                                                  monkeypatch):
    """One epoch (4 steps) of the joint recipe on the card, the batches
    from two forkserver workers started after the trainer's models are on
    the card: the same parameters and optimizer state as without
    workers."""
    torch.backends.cuda.matmul.allow_tf32 = False
    monkeypatch.chdir(tmp_path)
    trainers = [tcli.main(_argv(files, str(tmp_path / f"w{n}"),
                                device="cuda", input_workers=n,
                                max_epochs=1))
                for n in (0, 2)]
    _same_state(*trainers)
