"""PyTorch port at the head widths the card took only from the kernels'
widening: dh 96 (d 192 over 2 heads) and dh 256 (d 256 over 1 head), both
outside the 32 / 64 / 128 that the kernels were once built for.

On the CPU, against the JAX package on the same parameters (carried over by
bridge.params_from_jax) and the same numpy inputs, for the transformer
captioner and the transformer NMT at one or two layers:

- teacher-forced logprobs (captioner) and generator logits (NMT), atol 1e-5
  (f32, as tests/test_torch_transformer.py);
- greedy and beam decodes token-identical, scores atol 1e-4 (captioner) and
  1e-5 (NMT), as the existing decode tests state;
- two XE steps of `Trainer.train` against the JAX `Trainer`, every dropout 0
  and Adam eps 1e-6: losses, and parameters after the steps (the gradients'
  effect), within 1e-5, as tests/test_torch_train_transformer.py and
  tests/test_torch_train_nmt.py. The captioner steps run on the whole
  encoder and decoder layer route, the NMT's encoder on whole layers.

The card's side of these widths (the kernels against their plain versions)
is in the `cuda` cases of test_torch_mha_train.py, test_torch_layer_train.py
and test_torch_transformer_decode.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unpaired_image_captioning_tpu import constants as C
from unpaired_image_captioning_tpu import models as jmodels
from unpaired_image_captioning_tpu.config import Config
from unpaired_image_captioning_tpu.models import nmt_transformer as jnt
from unpaired_image_captioning_tpu.models import transformer as jtr
from unpaired_image_captioning_tpu.models.base import Features as JFeatures
from unpaired_image_captioning_tpu_torch import bridge
from unpaired_image_captioning_tpu_torch import models as tmodels
from unpaired_image_captioning_tpu_torch.config import Config as TConfig
from unpaired_image_captioning_tpu_torch.models import nmt_transformer as tnt
from unpaired_image_captioning_tpu_torch.models import transformer as ttr
from unpaired_image_captioning_tpu_torch.models.base import Features
from unpaired_image_captioning_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

# (d, heads): head widths 96 and 256
WIDTHS = {"dh96": (192, 2), "dh256": (256, 1)}
V, T, B, N = 21, 6, 3, 5
TOL = 1e-5


def _cap_cfg(d, heads, **kw):
    return dict(caption_model="transformer", vocab_size=V, rnn_size=48,
                num_layers=2, input_encoding_size=d, att_hid_size=16,
                fc_feat_size=10, att_feat_size=12, seq_length=T,
                drop_prob_lm=0.0, num_heads=heads, **kw)


def _feats(seed=0):
    rs = np.random.RandomState(seed)
    fc = rs.randn(B, 10).astype(np.float32)
    att = rs.randn(B, N, 12).astype(np.float32)
    masks = np.ones((B, N), np.float32)
    masks[0, 3:] = 0.0
    return (JFeatures(fc_feats=jnp.asarray(fc), att_feats=jnp.asarray(att),
                      att_masks=jnp.asarray(masks)),
            Features(fc_feats=torch.from_numpy(fc),
                     att_feats=torch.from_numpy(att),
                     att_masks=torch.from_numpy(masks)))


@pytest.fixture(scope="module", params=list(WIDTHS))
def captioner(request):
    d, heads = WIDTHS[request.param]
    cfg = Config(**_cap_cfg(d, heads))
    jm = jmodels.setup(cfg)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tm = tmodels.setup(cfg, device="cpu")
    tm.load_state_dict(bridge.params_from_jax(jp))
    tm.eval()
    return jm, jp, tm


def test_captioner_logprobs_match_jax(captioner):
    jm, jp, tm = captioner
    jf, tf = _feats()
    seq = np.random.RandomState(1).randint(0, V + 1, (B, T + 2)).astype(
        np.int32)
    seq[:, 0] = 0
    seq[1, 4:] = 0
    jl = jm.forward(jp, jf, jnp.asarray(seq), training=False)
    with torch.no_grad():
        tl = tm.forward(tf, torch.from_numpy(seq).long())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)


@pytest.mark.parametrize("stack", [True, False], ids=["stack", "per-layer"])
def test_captioner_greedy_and_beam_match_jax(captioner, monkeypatch, stack):
    """Both decode routes (the whole-stack step and the per-layer step)."""
    jm, jp, tm = captioner
    monkeypatch.setattr(ttr, "STACK_KERNEL", stack)
    jf, tf = _feats(2)
    jseq, _ = jax.jit(lambda p, f: jm.sample(p, f, jax.random.PRNGKey(1),
                                             greedy=True))(jp, jf)
    seq, _ = tm.sample(tf)
    np.testing.assert_array_equal(seq.numpy(), np.asarray(jseq))
    jr = jax.jit(lambda p, f: jm.sample_beam(p, f, beam_size=3))(jp, jf)
    with torch.no_grad():
        tr = tm.sample_beam(tf, beam_size=3)
    np.testing.assert_array_equal(tr.seq.numpy(), np.asarray(jr.seq))
    np.testing.assert_allclose(tr.scores.numpy(), np.asarray(jr.scores),
                               atol=1e-4)


def _cap_batch(seed=0):
    rs = np.random.RandomState(seed)
    labels = np.zeros((B, T + 2), np.int64)
    masks = np.zeros((B, T + 2), np.float32)
    for i, n in enumerate((T, 3, 1)):
        labels[i, 1:1 + n] = rs.randint(1, V + 1, n)
        masks[i, :n + 2] = 1.0
    att_masks = np.ones((B, N), np.float32)
    att_masks[1, 4:] = 0.0
    return {"fc_feats": rs.randn(B, 10).astype(np.float32),
            "att_feats": rs.randn(B, N, 12).astype(np.float32),
            "att_masks": att_masks, "labels": labels, "masks": masks}


def _params_close(tree_j, model, what):
    got = bridge.params_to_numpy(model)
    flat = jax.tree_util.tree_leaves_with_path(tree_j)
    assert len(flat) == len(list(model.parameters()))
    for path, want in flat:
        node = got
        for p in path:
            node = node[getattr(p, "key", getattr(p, "idx", None))]
        np.testing.assert_allclose(node, np.asarray(want), rtol=TOL, atol=TOL,
                                   err_msg=f"{what}{jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("width", list(WIDTHS))
def test_captioner_xe_steps_match_jax_trainer(tmp_path, monkeypatch, width):
    from unpaired_image_captioning_tpu.train.trainer import Trainer as JT

    d, heads = WIDTHS[width]
    monkeypatch.setattr(jtr, "DROPOUT", 0.0)
    monkeypatch.setattr(ttr, "DROPOUT", 0.0)
    monkeypatch.setattr(ttr, "TRAIN_LAYER_KERNEL", True)
    monkeypatch.setattr(ttr, "TRAIN_DEC_LAYER_KERNEL", True)
    kw = dict(_cap_cfg(d, heads), batch_size=B, seq_per_img=1,
              i2t_train_flag=True, i2t_max_grad_norm=5.0,
              i2t_learning_rate=5e-4, seed=7, i2t_optim_epsilon=1e-6)
    jt = JT(Config(**kw, dtype="float32", checkpoint_path=str(tmp_path)))
    pt = Trainer(TConfig(**kw), device="cpu")
    pt.i2t_model.load_state_dict(bridge.params_from_jax(jt.i2t_params))
    batch = _cap_batch()
    for _ in range(2):
        jm = jt.train(batch)
        tm = pt.train(batch)
        np.testing.assert_allclose(tm["i2t_loss"], jm["i2t_loss"], rtol=TOL,
                                   atol=TOL)
    _params_close(jt.i2t_params, pt.i2t_model, "i2t")


# ---------------------------------------------------------------------------
# the transformer NMT
# ---------------------------------------------------------------------------

SRC_V, TGT_V, S, TT = 31, 29, 7, 6


def _nmt_kw(d, heads):
    return dict(src_vocab_size=SRC_V, tgt_vocab_size=TGT_V, d_model=d,
                d_ff=48, num_layers=1, num_heads=heads, max_decode_len=7)


def _nmt_batch(seed=2):
    rs = np.random.RandomState(seed)
    lengths = np.array([S, S - 2, 3], np.int32)
    src = rs.randint(4, SRC_V, (3, S)).astype(np.int32)
    src[np.arange(S)[None, :] >= lengths[:, None]] = C.PAD
    tgt = rs.randint(4, TGT_V, (3, TT)).astype(np.int32)
    tgt[:, 0] = C.BOS
    tgt[:, -1] = C.EOS
    tgt[2, 4:] = C.PAD
    return src, lengths, tgt


def _t(a):
    return torch.from_numpy(np.asarray(a)).long()


@pytest.fixture(scope="module", params=list(WIDTHS))
def nmt(request):
    kw = _nmt_kw(*WIDTHS[request.param])
    jm = jnt.TransformerNMTModel(**kw)
    jp = jm.init_params(jax.random.PRNGKey(1))
    tm = tnt.TransformerNMTModel(**kw)
    tm.load_state_dict(bridge.params_from_jax(jp))
    tm.eval()
    return jm, jp, tm


def test_nmt_logits_match_jax(nmt):
    jm, jp, tm = nmt
    src, lengths, tgt = _nmt_batch()
    jout, _ = jm.forward(jp, jnp.asarray(src), jnp.asarray(lengths),
                         jnp.asarray(tgt))
    jlog = jm.generator_logits(jp, jout)
    with torch.no_grad():
        tout, _ = tm.forward(_t(src), _t(lengths), _t(tgt))
        tlog = tm.generator_logits(tout)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-5)


@pytest.mark.parametrize("beam", [1, 3])
def test_nmt_greedy_and_beam_match_jax(nmt, beam):
    """Beam 1 is the greedy decode."""
    jm, jp, tm = nmt
    src, lengths, _ = _nmt_batch()
    jr = jm.translate_batch(jp, jnp.asarray(src), jnp.asarray(lengths),
                            beam_size=beam)
    with torch.no_grad():
        tr = tm.translate_batch(_t(src), _t(lengths), beam_size=beam)
    np.testing.assert_array_equal(tr.seq.numpy(), np.asarray(jr.seq))
    np.testing.assert_array_equal(tr.aux.numpy(), np.asarray(jr.aux))
    np.testing.assert_allclose(tr.scores.numpy(), np.asarray(jr.scores),
                               atol=1e-5)


@pytest.mark.parametrize("width", list(WIDTHS))
def test_nmt_xe_steps_match_jax_trainer(tmp_path, monkeypatch, width):
    from unpaired_image_captioning_tpu.train.trainer import Trainer as JT

    d, heads = WIDTHS[width]
    monkeypatch.setattr(jtr, "DROPOUT", 0.0)
    monkeypatch.setattr(ttr, "DROPOUT", 0.0)
    kw = dict(vocab_size=0, nmt_src_vocab_size=SRC_V,
              nmt_tgt_vocab_size=TGT_V, nmt_model_type="transformer",
              word_vec_size=d, rnn_size=48, layers=1, num_heads=heads,
              dropout=0.0, batch_size=3, i2t_train_flag=False,
              nmt_train_flag=True, nmt_optim="adam", nmt_learning_rate=5e-4,
              nmt_optim_epsilon=1e-6, seed=3)
    jt = JT(Config(**kw, dtype="float32", checkpoint_path=str(tmp_path)))
    pt = Trainer(TConfig(**kw), device="cpu")
    pt.nmt_model.load_state_dict(bridge.params_from_jax(jt.nmt_params))
    src, lengths, tgt = _nmt_batch(4)
    batch = {"nmt": {"src": src, "lengths": lengths, "tgt": tgt}}
    for _ in range(2):
        jm = jt.train(batch)
        tm = pt.train(batch)
        np.testing.assert_allclose(tm["nmt_loss"], jm["nmt_loss"], rtol=TOL,
                                   atol=TOL)
    _params_close(jt.nmt_params, pt.nmt_model, "nmt")
