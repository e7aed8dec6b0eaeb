"""PyTorch port, the denseatt captioner: teacher-forced logprobs and the
caption beam against the JAX package on the same parameters (carried over
by bridge.params_from_jax) and the same numpy features.

Tolerances: forward logprobs atol 1e-5 (f32); beam tokens identical and
scores / per-token logprobs atol 1e-4 (sums over up to 8 steps)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unpaired_image_captioning_tpu import models as jmodels
from unpaired_image_captioning_tpu.config import Config
from unpaired_image_captioning_tpu.models.base import Features as JFeatures
from unpaired_image_captioning_tpu_torch import bridge
from unpaired_image_captioning_tpu_torch import models as tmodels
from unpaired_image_captioning_tpu_torch.models.base import Features

torch.set_num_threads(1)

B, N = 4, 6
CFG = Config(caption_model="denseatt", vocab_size=31, rnn_size=32,
             num_layers=1, input_encoding_size=16, att_hid_size=16,
             fc_feat_size=32, att_feat_size=24, seq_length=8,
             drop_prob_lm=0.3)


@pytest.fixture(scope="module")
def pair():
    jm = jmodels.setup(CFG)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tm = tmodels.setup(CFG, device="cpu")
    tm.load_state_dict(bridge.params_from_jax(jp))
    tm.eval()
    rs = np.random.RandomState(0)
    fc = rs.randn(B, CFG.fc_feat_size).astype(np.float32)
    att = rs.randn(B, N, CFG.att_feat_size).astype(np.float32)
    masks = np.ones((B, N), np.float32)
    masks[1, 4:] = 0.0                      # padded attention slots
    masks[3, 2:] = 0.0
    jf = JFeatures(fc_feats=jnp.asarray(fc), att_feats=jnp.asarray(att),
                   att_masks=jnp.asarray(masks))
    tf = Features(fc_feats=torch.from_numpy(fc),
                  att_feats=torch.from_numpy(att),
                  att_masks=torch.from_numpy(masks))
    return jm, jp, tm, jf, tf


def test_param_tree_round_trip(pair):
    jm, jp, tm, _, _ = pair
    back = bridge.params_to_numpy(tm)
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    flat_t = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_j] == [p for p, _ in flat_t]
    for (_, a), (_, b) in zip(flat_j, flat_t):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_init_params_shapes_match_jax(pair):
    jm, jp, _, _, _ = pair
    fresh = tmodels.setup(CFG, device="cpu").init_params(torch.Generator().manual_seed(0))
    shapes_t = jax.tree_util.tree_map(np.shape, bridge.params_to_numpy(fresh))
    shapes_j = jax.tree_util.tree_map(np.shape, jp)
    assert shapes_t == shapes_j
    emb = fresh.embed.detach()
    assert float(emb.abs().max()) <= 0.1 and float(emb.std()) > 0.04


def test_forward_logprobs_match_jax(pair):
    jm, jp, tm, jf, tf = pair
    seq = np.random.RandomState(1).randint(
        1, CFG.vocab_size + 1, (B, CFG.seq_length + 2)).astype(np.int32)
    seq[:, 0] = 0
    jl = jm.forward(jp, jf, jnp.asarray(seq), training=False)
    with torch.no_grad():
        tl = tm.forward(tf, torch.from_numpy(seq).long())
    assert tl.shape == (B, CFG.seq_length + 1, CFG.vocab_size + 1)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)


@pytest.mark.parametrize("beam,opts", [
    (3, {}), (5, {}),
    (3, {"decoding_constraint": True, "max_ppl": True}),
    (5, {"eos_bias": 3.0})],
    ids=["beam3", "beam5", "beam3-constraint-max_ppl", "beam5-early-eos"])
def test_sample_beam_matches_jax(pair, beam, opts):
    """eos_bias raises the EOS (id 0) logit so that beams finish early,
    become -1000 dead slots, and the loop exits before seq_length."""
    jm, jp, tm, jf, tf = pair
    opts = dict(opts)
    eos_bias = opts.pop("eos_bias", 0.0)
    if eos_bias:
        logit = [dict(jp["logit"][0])]
        logit[0]["b"] = logit[0]["b"].at[0].add(eos_bias)
        jp = {**jp, "logit": logit}
        tm = tmodels.setup(CFG, device="cpu")
        tm.load_state_dict(bridge.params_from_jax(jp))
    jr = jax.jit(lambda p, f: jm.sample_beam(p, f, beam_size=beam,
                                             **opts))(jp, jf)
    with torch.no_grad():
        tr = tm.sample_beam(tf, beam_size=beam, **opts)
    if eos_bias:
        assert (np.asarray(jr.seq)[:, 0, -1] == 0).all()
    np.testing.assert_array_equal(tr.seq.numpy(), np.asarray(jr.seq))
    np.testing.assert_allclose(tr.scores.numpy(), np.asarray(jr.scores),
                               atol=1e-4)
    np.testing.assert_allclose(tr.logps.numpy(), np.asarray(jr.logps),
                               atol=1e-4)


def test_unported_options_raise(pair):
    # the other families and use_bn build since A10
    # (tests/test_torch_families.py, tests/test_torch_batchnorm.py), and
    # diverse beam groups decode as JAX's (tests/test_torch_diverse_beam.py)
    assert type(tmodels.setup(Config(caption_model="topdown", vocab_size=5,
                                     rnn_size=8, input_encoding_size=8,
                                     fc_feat_size=8, att_feat_size=8),
                              device="cpu")).__name__ == "TopDownModel"
    assert hasattr(tmodels.setup(Config(caption_model="denseatt",
                                        vocab_size=5, rnn_size=8,
                                        input_encoding_size=8,
                                        fc_feat_size=8, att_feat_size=8,
                                        use_bn=1), device="cpu"), "bn0")
    with pytest.raises(ValueError, match="not supported"):
        tmodels.setup(Config(caption_model="nosuch", vocab_size=5),
                      device="cpu")
    jm, jp, tm, jf, tf = pair
    jr = jax.jit(lambda p, f: jm.sample_beam(p, f, beam_size=4,
                                             group_size=2))(jp, jf)
    with torch.no_grad():
        tr = tm.sample_beam(tf, beam_size=4, group_size=2)
    np.testing.assert_array_equal(tr.seq.numpy(), np.asarray(jr.seq))
    np.testing.assert_allclose(tr.scores.numpy(), np.asarray(jr.scores),
                               atol=1e-5)
    with pytest.raises(ValueError, match="divisible"):
        tm.sample_beam(tf, beam_size=4, group_size=3)


def test_stackatt_forward_matches_jax(pair):
    """The stackatt family (no fusion layers) through `models.setup`."""
    _, _, _, jf, tf = pair
    cfg = Config(**{**vars(CFG), "caption_model": "stackatt"})
    jm = jmodels.setup(cfg)
    jp = jm.init_params(jax.random.PRNGKey(3))
    tm = tmodels.setup(cfg, device="cpu")
    assert type(tm).__name__ == "StackAttModel"
    tm.load_state_dict(bridge.params_from_jax(jp))
    seq = np.random.RandomState(4).randint(
        0, CFG.vocab_size + 1, (B, 6)).astype(np.int32)
    jl = jm.forward(jp, jf, jnp.asarray(seq), training=False)
    with torch.no_grad():
        tl = tm.forward(tf, torch.from_numpy(seq).long())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)
