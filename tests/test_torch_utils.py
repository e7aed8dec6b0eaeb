"""The port's host utilities (`utils/bpe.py`, `utils/report.py`,
`utils/word_cloud.py`, `utils/vis_words.py`, `native.query_integral_image`)
against the JAX package's on the same inputs and seeds: the learned BPE
codes line for line (frequency ties included), the segmentation, and the
HTML / SVG files byte for byte; the free-position search through the C++
helper and through its Python twin."""

import numpy as np
import pytest

from unpaired_image_captioning_tpu_torch import native

CAPTIONS = ["a cat on a mat", "a dog runs fast", "the cat sleeps",
            "a cat & a <dog>", "birds fly over the old bridge",
            "the the the cat", "a man rides a horse", "zebras graze"]


def _bpe_corpus(seed):
    """Words over a 5-letter alphabet with many equal pair counts, so the
    order among ties decides the codes."""
    rs = np.random.RandomState(seed)
    letters = np.array(list("abcde"))
    return [" ".join("".join(letters[rs.randint(0, 5, rs.randint(1, 7))])
                     for _ in range(rs.randint(1, 9))) for _ in range(40)]


@pytest.mark.parametrize("merges,min_frequency", [(30, 2), (200, 1)])
def test_bpe_matches_jax(merges, min_frequency, tmp_path):
    from unpaired_image_captioning_tpu.utils import bpe as jbpe

    from unpaired_image_captioning_tpu_torch.utils import bpe

    corpus = _bpe_corpus(0) + ["a b a b", "ab ba ab"]
    codes = bpe.learn_bpe(corpus, num_merges=merges,
                          min_frequency=min_frequency)
    assert codes == jbpe.learn_bpe(corpus, num_merges=merges,
                                   min_frequency=min_frequency)
    assert len(codes) >= 20
    bpe.save_codes(codes, str(tmp_path / "port.codes"))
    jbpe.save_codes(codes, str(tmp_path / "jax.codes"))
    assert (tmp_path / "port.codes").read_bytes() == (
        tmp_path / "jax.codes").read_bytes()
    assert bpe.load_codes(str(tmp_path / "jax.codes")) == codes
    seg, jseg = bpe.BPE(codes), jbpe.BPE(codes)
    for line in _bpe_corpus(1) + ["", "edcba xyz"]:
        out = seg.segment(line)
        assert out == jseg.segment(line)
        assert bpe.BPE.decode(out) == jbpe.BPE.decode(out) == " ".join(
            line.split())


def test_html_report_is_byte_equal(tmp_path):
    from unpaired_image_captioning_tpu.utils.report import (
        html_report as jreport)

    from unpaired_image_captioning_tpu_torch.utils.report import html_report

    preds = [{"image_id": i, "caption": c,
              **({"file_path": f"img/{i}<x>.jpg"} if i % 2 else {})}
             for i, c in enumerate(CAPTIONS)]
    refs = {0: ["a cat", "the \"cat\""], 3: ["dogs & cats"]}
    paths = [fn(preds, str(tmp_path / name / "r.html"), references=refs,
                title="val <captions>")
             for fn, name in ((html_report, "port"), (jreport, "jax"))]
    got, want = (open(p, "rb").read() for p in paths)
    assert got == want and b"&lt;dog&gt;" in got


def test_word_cloud_is_byte_equal(tmp_path):
    from unpaired_image_captioning_tpu.utils import word_cloud as jwc

    from unpaired_image_captioning_tpu_torch.utils import word_cloud

    for kw in ({}, {"width": 300, "height": 150, "seed": 3, "top_k": 5}):
        svgs = [mod.word_cloud_from_captions(
                    CAPTIONS, str(tmp_path / f"{name}.svg"), **kw)
                for mod, name in ((word_cloud, "port"), (jwc, "jax"))]
        assert svgs[0] == svgs[1] and svgs[0].count("<text") >= 5
        assert (tmp_path / "port.svg").read_bytes() == (
            tmp_path / "jax.svg").read_bytes()
    freqs = {"cat": 10.0, "dog": 6.0, "horse": 3.0, "zebra": 1.0}
    placed = word_cloud.layout_words(freqs, width=300, height=150, seed=1)
    assert placed == jwc.layout_words(freqs, width=300, height=150, seed=1)
    assert word_cloud.layout_words({}) == []


def test_vis_words_is_byte_equal(tmp_path):
    from unpaired_image_captioning_tpu.utils.vis_words import (
        vis_words as jvis)

    from unpaired_image_captioning_tpu_torch.utils.vis_words import vis_words

    a, b = CAPTIONS[:5], CAPTIONS[3:] + ["the cat is here"]
    paths = [fn(a, b, str(tmp_path / name / "vw.html"), label_a="gen",
                label_b="refs <zh>", top_k=12)
             for fn, name in ((vis_words, "port"), (jvis, "jax"))]
    got, want = (open(p, "rb").read() for p in paths)
    assert got == want and b"<circle" in got


def _integrals():
    rs = np.random.RandomState(0)
    occ = (rs.rand(23, 31) < 0.08).astype(np.uint32)
    occ[:6, :9] = 1
    full = np.ones((8, 8), np.uint32)
    return [occ.cumsum(0).cumsum(1).astype(np.uint32),
            full.cumsum(0).cumsum(1).astype(np.uint32)]


@pytest.mark.parametrize("route", ["cpp", "python"])
def test_query_integral_image_matches_jax(route):
    from unpaired_image_captioning_tpu import native as jnative

    if route == "cpp":
        assert native.has_native()
        query = native.query_integral_image
    else:
        query = native._query_integral_image_py
    found = 0
    for integral in _integrals():
        for size in ((2, 2), (3, 5), (6, 2), (12, 20), (30, 1)):
            for hit in (0, 1, 17, 2 ** 31 - 2):
                got = query(integral, *size, hit)
                assert got == jnative.query_integral_image(integral, *size,
                                                           hit)
                found += got is not None
    assert found > 10


def test_word_cloud_takes_either_route(monkeypatch):
    """The layout through the C++ helper equals the layout through the
    Python twin (the route of a machine without a compiler)."""
    from unpaired_image_captioning_tpu_torch.utils import word_cloud

    freqs = {w: float(len(w)) for c in CAPTIONS for w in c.split()}
    cpp = word_cloud.layout_words(freqs, width=200, height=100, seed=2)
    monkeypatch.setattr(native, "_lib", lambda: None)
    assert word_cloud.layout_words(freqs, width=200, height=100,
                                   seed=2) == cpp
    assert len(cpp) > 3
