"""PyTorch port, the chunked top-k for 16 < k <= 64
(`kernels/chunked_topk.py`) and the beams wider than 16 that it serves.

- `chunked_topk_plain` against the JAX package's `_chunked_topk` in
  interpret mode (the Pallas ranking kernel run as the JAX tests run it),
  for k in {17, 32, 64} at a 128-multiple and a ragged row length, on rows
  built to break a naive version: ties, one chunk holding most of the top
  k, equal values straddling chunk boundaries, and -inf / +inf entries,
  which the route clamps to the finite range. Exact: values and indices
  equal.
- `topk_route` against the branches of the JAX `row_topk`
  (`topk.py:321-332`).
- The NMT's `translate_batch` and the captioner's `sample_beam` at beam 20,
  token-identical to the JAX package at tiny widths.
- On a card (`cuda` marker): the kernel against its plain version at the
  wide-beam shapes (the routes of `ops/topk.py::row_topk` are held in
  `test_torch_topk.py`). On a card machine without jax, run them with

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_chunked_topk.py
"""

import numpy as np
import pytest
import torch

from unpaired_image_captioning_tpu_torch import bridge
from unpaired_image_captioning_tpu_torch import constants as C
from unpaired_image_captioning_tpu_torch.kernels import chunked_topk as ck
from unpaired_image_captioning_tpu_torch.ops import topk as ot

torch.set_num_threads(1)

KS = (17, 32, 64)
VS = (16384, 16421)          # a 128-multiple and a ragged row length
F32_MIN = np.finfo(np.float32).min
F32_MAX = np.finfo(np.float32).max


def _rows(v: int, k: int, seed: int) -> np.ndarray:
    rs = np.random.RandomState(seed)
    x = rs.randn(6, v).astype(np.float32)
    x[1] = np.round(x[1] * 2) / 2                 # many exact ties
    # one chunk (2) holds most of the top k; two chunks interleave
    x[2] = -10.0
    x[2, 256:256 + k - 2] = np.linspace(100, 60, k - 2, dtype=np.float32)
    x[2, 5] = 95.0
    x[2, v - 3] = 94.5
    # equal values straddling chunk boundaries, more of them than k
    x[3] = -1.0
    for c in range(1, k + 4):
        x[3, c * 128 - 1:c * 128 + 1] = 7.0
    x[3, 40] = 9.0
    # a mostly -inf row: the selected -inf come back clamped, +inf too
    x[4] = -np.inf
    x[4, rs.choice(v, k // 2, replace=False)] = rs.randn(k // 2)
    x[4, 3] = np.inf
    x[5] = -np.inf                                # an all -inf row
    return x


@pytest.fixture(scope="module")
def jax_results():
    """The JAX package's chunked route on each (k, v), computed once."""
    import jax.numpy as jnp

    from unpaired_image_captioning_tpu.ops.topk import _chunked_topk

    out = {}
    for k in KS:
        for v in VS:
            x = _rows(v, k, seed=k + v)
            jv, ji = _chunked_topk(jnp.asarray(x), k, interpret=True)
            out[k, v] = (x, np.asarray(jv), np.asarray(ji))
    return out


@pytest.mark.parametrize("v", VS, ids=["v128x", "ragged"])
@pytest.mark.parametrize("k", KS)
def test_plain_matches_jax_chunked_route(jax_results, k, v):
    x, jv, ji = jax_results[k, v]
    tv, ti = ck.chunked_topk_plain(torch.from_numpy(x), k)
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_array_equal(tv.numpy(), jv)
    # the clamp: a selected -inf is the float minimum, +inf the maximum
    assert tv[4, 0].item() == F32_MAX and tv[4, -1].item() == F32_MIN
    np.testing.assert_array_equal(ti[5].numpy(), np.arange(k))
    # and the CPU wrapper is the plain version
    cv, ci = ck.chunked_topk(torch.from_numpy(x), k)
    assert torch.equal(cv, tv) and torch.equal(ci, ti)


def _jax_branch(k: int, v: int) -> str:
    """The branches of the JAX `row_topk` on a TPU (`topk.py:321-332`) for
    an f32 [R, v] array, by the kernel each takes."""
    if v >= 256:
        if k <= 2:
            return "iterative"
        m = 2 if k <= 3 else 3 if k <= 6 else 4
        if k <= 16 and v > (m + 1) * 128:
            return "lane"
        if k * 128 * 2 <= v and k <= 64:
            return "chunked"
    return "lax.top_k"


@pytest.mark.parametrize("v", [100, 256, 640, 4351, 4352, 8571, 9488, 16384])
@pytest.mark.parametrize("k", [1, 2, 3, 5, 15, 16, 17, 20, 32, 33, 34, 37,
                               40, 64, 65])
def test_topk_route_follows_the_jax_branches(k, v):
    """Above k = 16 the port routes as the JAX package: the chunked kernel
    exactly where the JAX route is the chunked one, else the sort that
    stands for `lax.top_k`. At k <= 16 the port's row kernel takes any row
    length (the JAX lane kernel's width gates are TPU tiling, and its
    fallback computes the same function)."""
    route = ot.topk_route(k, v)
    want = _jax_branch(k, v)
    if k <= 16:
        assert route == "row_topk"
    else:
        assert route == {"chunked": "chunked_topk",
                         "lax.top_k": "sort"}[want]


def test_row_topk_on_the_cpu_is_the_stable_sort():
    """Off the card every k takes the stable sort, as the JAX package off
    the TPU takes lax.top_k: no clamp, ties to the lowest index."""
    x = torch.full((2, 5000), float("-inf"))
    x[:, 7] = x[:, 4000] = 1.0
    n0 = ot.sort_calls
    v, i = ot.row_topk(x, 20)
    assert ot.sort_calls == n0                      # counted on the card
    assert v[0, 0] == 1.0 and v[0, 2] == float("-inf")
    np.testing.assert_array_equal(i[0, :4].numpy(), [7, 4000, 0, 1])


# ---------------------------------------------------------------------------
# beams wider than 16 against the JAX package
# ---------------------------------------------------------------------------

BEAM = 20


def test_translate_beam20_matches_jax():
    import jax
    import jax.numpy as jnp

    from unpaired_image_captioning_tpu.models.nmt import NMTModel as JNMT
    from unpaired_image_captioning_tpu_torch.models.nmt import NMTModel

    kw = dict(src_vocab_size=31, tgt_vocab_size=29, word_vec_size=16,
              rnn_size=24, layers=1, dropout=0.3, max_decode_len=8)
    jm = JNMT(**kw)
    jp = jm.init_params(jax.random.PRNGKey(3))
    tm = NMTModel(**kw, device="cpu")
    tm.load_state_dict(bridge.params_from_jax(jp))
    rs = np.random.RandomState(4)
    lengths = np.array([6, 3, 1], np.int32)
    src = rs.randint(4, 31, (3, 6)).astype(np.int32)
    src[np.arange(6)[None, :] >= lengths[:, None]] = C.PAD
    jr = jax.jit(lambda p, s, n: jm.translate_batch(p, s, n,
                                                    beam_size=BEAM))(
        jp, jnp.asarray(src), jnp.asarray(lengths))
    with torch.no_grad():
        tr = tm.translate_batch(torch.from_numpy(src).long(),
                                torch.from_numpy(lengths).long(),
                                beam_size=BEAM)
    assert tr.seq.shape == (3, BEAM, 8)
    np.testing.assert_array_equal(tr.seq.numpy(), np.asarray(jr.seq))
    np.testing.assert_array_equal(tr.aux.numpy(), np.asarray(jr.aux))
    np.testing.assert_allclose(tr.scores.numpy(), np.asarray(jr.scores),
                               atol=1e-4)


def test_caption_beam20_matches_jax():
    import jax
    import jax.numpy as jnp

    from unpaired_image_captioning_tpu import models as jmodels
    from unpaired_image_captioning_tpu.config import Config
    from unpaired_image_captioning_tpu.models.base import Features as JF
    from unpaired_image_captioning_tpu_torch import models as tmodels
    from unpaired_image_captioning_tpu_torch.models.base import Features

    cfg = Config(caption_model="denseatt", vocab_size=31, rnn_size=24,
                 num_layers=1, input_encoding_size=16, att_hid_size=16,
                 fc_feat_size=16, att_feat_size=16, seq_length=6,
                 drop_prob_lm=0.3)
    jm = jmodels.setup(cfg)
    jp = jm.init_params(jax.random.PRNGKey(5))
    tm = tmodels.setup(cfg, device="cpu")
    tm.load_state_dict(bridge.params_from_jax(jp))
    tm.eval()
    rs = np.random.RandomState(6)
    fc = rs.randn(2, 16).astype(np.float32)
    att = rs.randn(2, 5, 16).astype(np.float32)
    masks = np.ones((2, 5), np.float32)
    masks[1, 3:] = 0.0
    jr = jax.jit(lambda p, f: jm.sample_beam(p, f, beam_size=BEAM))(
        jp, JF(fc_feats=jnp.asarray(fc), att_feats=jnp.asarray(att),
               att_masks=jnp.asarray(masks)))
    with torch.no_grad():
        tr = tm.sample_beam(Features(fc_feats=torch.from_numpy(fc),
                                     att_feats=torch.from_numpy(att),
                                     att_masks=torch.from_numpy(masks)),
                            beam_size=BEAM)
    assert tr.seq.shape == (2, BEAM, 6)
    np.testing.assert_array_equal(tr.seq.numpy(), np.asarray(jr.seq))
    np.testing.assert_allclose(tr.scores.numpy(), np.asarray(jr.scores),
                               atol=1e-4)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("r,v,k", [(1600, 8571, 32), (1000, 9488, 20),
                                   (1600, 9488, 32), (256, 16384, 64),
                                   (6, 16421, 17)])
def test_cuda_chunked_topk_matches_plain(cuda_dev, r, v, k):
    g = torch.Generator(device=cuda_dev).manual_seed(k)
    x = torch.randn((r, v), generator=g, device=cuda_dev)
    x[:6] = torch.from_numpy(_rows(v, k, seed=k)).to(cuda_dev)
    x[6:10] = torch.round(x[6:10] * 2) / 2
    before = ck.launches
    vk, ik = ck.chunked_topk(x, k)
    vp, ip = ck.chunked_topk_plain(x, k)
    assert ck.launches == before + 1
    assert torch.equal(vk, vp) and torch.equal(ik, ip)
