"""The port's on-device CIDEr-D / BLEU-4 (`ops/cider.py`) and the
prepro_ngrams df artifact (`scripts/prepro_ngrams.py`) against the JAX
package on the CPU.

The n-gram hashes and the df table are bit-identical to the JAX package's
(a table built by either side is probed alike); the all-probes-at-once
lookup returns what JAX's 16-iteration probe loop returns on a table with
long probe chains, a key past the 16th probe, a duplicated key and absent
keys; `cider_d` and `bleu4` agree within 1e-5 on padded sequences with
repeated n-grams and masked references, and `cider_d` matches the host
CiderD scorer within 1e-4 on `tests/test_metrics.py`'s fixture. The JAX
package is imported inside the tests, so the `cuda` case runs on a card
machine without jax.
"""

import math

import numpy as np
import pytest
import torch

from unpaired_image_captioning_tpu_torch.ops import cider as tc
from unpaired_image_captioning_tpu_torch.scripts import prepro_ngrams as tpre

TOL = 1e-5
B, R, T, V = 6, 4, 9, 7


def _corpus(seed=0, n_img=12, per_img=3, t=T, v=V):
    """Caption rows of a small vocabulary (so n-grams repeat), 0-padded,
    with each image's 1-based inclusive row range."""
    rs = np.random.RandomState(seed)
    labels = np.zeros((n_img * per_img, t), np.int32)
    for i in range(len(labels)):
        n = rs.randint(1, t + 1)
        labels[i, :n] = rs.randint(1, v + 1, n)
    start = np.arange(n_img) * per_img + 1
    return labels, start, start + per_img - 1


def _batch(seed=1):
    """Candidates with repeats, an empty one, one equal to a reference and
    one shorter than every 4-gram; references with masked rows (a masked
    row holds words, so a mask that is ignored shows)."""
    rs = np.random.RandomState(seed)
    refs = np.zeros((B, R, T), np.int64)
    for b in range(B):
        for r in range(R):
            n = rs.randint(2, T + 1)
            refs[b, r, :n] = rs.randint(1, V + 1, n)
    mask = np.ones((B, R), np.float32)
    mask[1, 2:] = 0.0
    mask[3, 1:] = 0.0
    cand = np.zeros((B, T), np.int64)
    for b, n in enumerate((T, 5, 0, T - 1, 3, 7)):
        cand[b, :n] = rs.randint(1, V + 1, n)
    cand[0, 3:6] = cand[0, 0:3]                 # a repeated trigram
    cand[3] = refs[3, 0]                        # equal to a reference
    return cand, refs, mask


def _jax():
    import jax
    import jax.numpy as jnp

    from unpaired_image_captioning_tpu.ops import cider as jc
    from unpaired_image_captioning_tpu.scripts import prepro_ngrams as jpre

    return jax, jnp, jc, jpre


def _tables():
    jc = _jax()[2]
    labels, start, end = _corpus()
    df, n_img = tpre.compute_df(labels, start, end)
    return (jc.build_df_table(df, float(n_img)),
            tc.build_df_table(df, float(n_img), device="cpu"))


def _u32(x):
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_ngram_hashes_and_stats_match_jax(n):
    _, jnp, jc, _ = _jax()
    cand, refs, _ = _batch()
    seq = np.concatenate([cand, refs.reshape(-1, T)])
    want = jc.ngram_hashes(jnp.asarray(seq, jnp.int32), n)
    # order n alone, and as cider_d / bleu4 hash it: all orders in one pass
    got = tc._hash_orders(torch.from_numpy(seq), (n,))[0]
    every = tc._hash_orders(torch.from_numpy(seq), (1, 2, 3, 4))[n - 1]
    for w, g, e in zip(want, got, every):
        np.testing.assert_array_equal(g.numpy(), _u32(w))
        np.testing.assert_array_equal(e.numpy(), _u32(w))
    jt, tt = _tables()
    ws = jc._sentence_stats(jnp.asarray(seq, jnp.int32), n, jt)
    gs = tc._stats(*got, tt)
    assert set(gs) == set(ws)
    for k in ("canonical", "valid", "tf"):
        np.testing.assert_array_equal(gs[k].numpy(), np.asarray(ws[k]))
    for k in ("idf", "g", "norm"):
        np.testing.assert_allclose(gs[k].numpy(), np.asarray(ws[k]),
                                   rtol=TOL, atol=TOL, err_msg=k)
    rs = np.random.RandomState(n)
    for ng in {tuple(int(t) for t in rs.randint(0, 2 ** 31, n))
               for _ in range(20)}:
        assert tc._host_hash(ng) == jc._host_hash(ng)


def test_build_df_table_is_jax_bit_for_bit():
    jc = _jax()[2]
    jt, tt = _tables()
    assert tt.size == jt.size
    np.testing.assert_array_equal(tt.h1.numpy(), _u32(jt.h1))
    np.testing.assert_array_equal(tt.h2.numpy(), _u32(jt.h2))
    np.testing.assert_array_equal(tt.df.numpy(), np.asarray(jt.df))
    assert tt.log_ref_len == jt.log_ref_len
    empty = tc.empty_df_table("cpu")
    assert empty.size == jc.empty_df_table().size == 8
    assert empty.log_ref_len == 0.0


def test_probe_matches_jax_loop():
    """A full table whose slot s holds a key first reached at probe k_s of
    its chain (k_s up to 20: past the 16th the JAX loop gives up), one key
    stored twice along its chain with two dfs (the first wins), and absent
    keys."""
    _, jnp, jc, _ = _jax()
    m, rs = 256, np.random.RandomState(0)
    h2 = rs.randint(0, 2 ** 32, m, dtype=np.int64)
    step = (h2 | 1) % m
    k = rs.randint(0, 21, m)
    k[:40] = np.arange(40) % 21
    k[41] = 3
    h1 = (np.arange(m) - k * step) % m + m * rs.randint(0, 2 ** 24, m)
    df = rs.randint(1, 50, m).astype(np.float32)
    # slot 41's key (probe 3 of its chain) again at probe 7, with another df
    dup = (41 + 4 * step[41]) % m
    h1[dup], h2[dup], df[dup], k[dup] = h1[41], h2[41], 99.0, 3
    q1 = np.concatenate([h1, rs.randint(0, 2 ** 32, 30, dtype=np.int64)])
    q2 = np.concatenate([h2, rs.randint(0, 2 ** 32, 30, dtype=np.int64)])
    q1, q2 = q1.reshape(2, -1), q2.reshape(2, -1)        # any leading shape
    jtab = jc.DfTable(jnp.asarray(h1, jnp.uint32), jnp.asarray(h2, jnp.uint32),
                      jnp.asarray(df), 0.0)
    ttab = tc.DfTable(torch.from_numpy(h1), torch.from_numpy(h2),
                      torch.from_numpy(df), 0.0)
    want = np.asarray(jc._df_lookup(jtab, jnp.asarray(q1, jnp.uint32),
                                    jnp.asarray(q2, jnp.uint32)))
    got = tc._df_lookup(ttab, torch.from_numpy(q1), torch.from_numpy(q2))
    np.testing.assert_array_equal(got.numpy(), want)
    flat = want.reshape(-1)
    found = k < tc._PROBES
    assert (flat[:m][found] > 0).all() and (flat[:m][~found] == 0).all()
    assert (flat[m:] == 0).all() and flat[41] == flat[dup] == df[41]


def test_cider_d_and_bleu4_match_jax():
    jax, jnp, jc, _ = _jax()
    cand, refs, mask = _batch()
    jt, tt = _tables()
    jargs = (jnp.asarray(cand, jnp.int32), jnp.asarray(refs, jnp.int32),
             jnp.asarray(mask))
    targs = (torch.from_numpy(cand), torch.from_numpy(refs),
             torch.from_numpy(mask))
    want_c = np.asarray(jax.jit(lambda *a: jc.cider_d(*a, jt))(*jargs))
    got_c = tc.cider_d(*targs, tt).numpy()
    np.testing.assert_allclose(got_c, want_c, rtol=TOL, atol=TOL)
    want_b = np.asarray(jax.jit(jc.bleu4)(*jargs))
    got_b = tc.bleu4(*targs).numpy()
    np.testing.assert_allclose(got_b, want_b, rtol=TOL, atol=TOL)
    assert got_c.dtype == got_b.dtype == np.float32
    # rows that score, and the empty candidate that does not
    assert (got_c[[0, 1, 3]] > 0).all() and got_c[2] == 0.0
    assert got_b[3] > 0.99


# tests/test_metrics.py's fixture
GTS = {
    1: ["a man is riding a horse", "a person rides a brown horse",
        "a man on a horse"],
    2: ["two dogs play in the park", "dogs playing on grass"],
    3: ["a cat sits on a mat", "the cat is on the mat"],
}
RES = {
    1: ["a man is riding a horse"],
    2: ["a dog plays in the park"],
    3: ["a dog sits on the grass"],
}


def test_cider_d_matches_host_scorer():
    from unpaired_image_captioning_tpu.eval.metrics import CiderD
    from unpaired_image_captioning_tpu.eval.metrics.cider import (
        compute_doc_freq, precook)

    vocab = sorted({w for v in list(GTS.values()) + list(RES.values())
                    for s in v for w in s.split()})
    w2i = {w: i + 1 for i, w in enumerate(vocab)}
    crefs = [[precook(r) for r in GTS[i]] for i in sorted(GTS)]
    df_words = compute_doc_freq(crefs)
    ref_len = float(len(crefs))
    _, host_scores = CiderD(df=df_words, ref_len=math.log(ref_len)
                            ).compute_score(GTS, RES)
    table = tc.build_df_table({tuple(w2i[w] for w in ng): v
                               for ng, v in df_words.items()}, ref_len,
                              device="cpu")

    def encode(sent, t=12):
        out = np.zeros((t,), np.int64)
        for i, w in enumerate(sent.split()[:t]):
            out[i] = w2i[w]
        return out

    ids = sorted(GTS)
    maxr = max(len(GTS[i]) for i in ids)
    cand = np.stack([encode(RES[i][0]) for i in ids])
    refs = np.zeros((len(ids), maxr, 12), np.int64)
    mask = np.zeros((len(ids), maxr), np.float32)
    for bi, i in enumerate(ids):
        for ri, sent in enumerate(GTS[i]):
            refs[bi, ri] = encode(sent)
            mask[bi, ri] = 1.0
    got = tc.cider_d(torch.from_numpy(cand), torch.from_numpy(refs),
                     torch.from_numpy(mask), table)
    np.testing.assert_allclose(got.numpy(), host_scores, rtol=1e-4,
                               atol=1e-4)


def test_prepro_ngrams_matches_jax(tmp_path):
    _, _, jc, jpre = _jax()
    labels, start, end = _corpus(3)
    split = np.arange(len(start)) % 3 != 1
    got = tpre.compute_df(labels, start, end, split_mask=split)
    want = jpre.compute_df(labels, start, end, split_mask=split)
    assert got == want and got[1] == int(split.sum())
    # each side reads the other's file
    tpre.save_df(str(tmp_path / "port.npz"), *got)
    jpre.save_df(str(tmp_path / "jax.npz"), *want)
    assert jpre.load_df(str(tmp_path / "port.npz")) == want
    assert tpre.load_df(str(tmp_path / "jax.npz")) == want
    # a JAX-written cache, named with or without its suffix, is JAX's table
    jtab = jc.build_df_table(*want)
    for path in (tmp_path / "jax.npz", tmp_path / "jax"):
        tab = tpre.load_df_table(str(path), device="cpu")
        np.testing.assert_array_equal(tab.h1.numpy(), _u32(jtab.h1))
        np.testing.assert_array_equal(tab.h2.numpy(), _u32(jtab.h2))
        np.testing.assert_array_equal(tab.df.numpy(), np.asarray(jtab.df))
        assert tab.log_ref_len == jtab.log_ref_len
    empty = tpre.load_df_table(str(tmp_path / "absent"), device="cpu")
    assert empty.size == 8 and empty.log_ref_len == 0.0
    assert not empty.df.any()


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_rewards_match_cpu(cuda_dev):
    """The rewards computed on the card equal the CPU's within 1e-5 *
    max(1, |cpu|): the hashes and the probe in int64, the statistics in
    f32."""
    df, n_img = tpre.compute_df(*_corpus())
    tabs = {d: tc.build_df_table(df, n_img, device=d)
            for d in ("cpu", cuda_dev)}
    host = [torch.from_numpy(a) for a in _batch()]
    for name in ("cider_d", "bleu4"):
        got, want = ((getattr(tc, name)(*[a.to(d) for a in host],
                                        *((tabs[d],) if name == "cider_d"
                                          else ())).cpu())
                     for d in (cuda_dev, "cpu"))
        assert ((got - want).abs() <= 1e-5 * want.abs().clamp(min=1.0)
                ).all(), name
