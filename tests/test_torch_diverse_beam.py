"""PyTorch port, diverse beam groups (`ops/beam_search.py::beam_search` with
group_size > 1) against the JAX package on the same parameters and
features, for the denseatt and the transformer captioners at tiny widths:
G = 2 and 3, with and without `decoding_constraint` and `max_ppl`, one
case whose raised EOS logit ends every group before the length cap (dead
slots and the early exit), and `diversity_lambda` 0 against 0.5. Tokens
identical; scores and per-token logprobs within 1e-5. The grouped
selection's tie order is held on rows of equal values."""

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
from unpaired_image_captioning_tpu_torch.ops.topk import row_topk

torch.set_num_threads(1)

B, N = 3, 5
CFGS = {
    "denseatt": Config(caption_model="denseatt", vocab_size=23, rnn_size=24,
                       num_layers=1, input_encoding_size=16, att_hid_size=16,
                       fc_feat_size=12, att_feat_size=12, seq_length=6,
                       drop_prob_lm=0.0),
    "transformer": Config(caption_model="transformer", vocab_size=21,
                          rnn_size=24, num_layers=2, input_encoding_size=16,
                          att_hid_size=16, fc_feat_size=12, att_feat_size=12,
                          seq_length=6, drop_prob_lm=0.0, num_heads=4),
}


@pytest.fixture(scope="module")
def pairs():
    rs = np.random.RandomState(0)
    fc = rs.randn(B, 12).astype(np.float32)
    att = rs.randn(B, N, 12).astype(np.float32)
    masks = np.ones((B, N), np.float32)
    masks[1, 3:] = 0.0
    jf = JFeatures(fc_feats=jnp.asarray(fc), att_feats=jnp.asarray(att),
                   att_masks=jnp.asarray(masks))
    tf = Features(fc_feats=torch.from_numpy(fc),
                  att_feats=torch.from_numpy(att),
                  att_masks=torch.from_numpy(masks))
    out = {}
    for name, cfg in CFGS.items():
        jm = jmodels.setup(cfg)
        jp = jm.init_params(jax.random.PRNGKey(3))
        out[name] = (jm, jp, jf, tf)
    return out


def _port(cfg, jp):
    tm = tmodels.setup(cfg, device="cpu")
    tm.load_state_dict(bridge.params_from_jax(jp))
    return tm.eval()


def _eos_biased(name, jp, bias):
    if name == "denseatt":
        logit = [dict(jp["logit"][0])]
        logit[0]["b"] = logit[0]["b"].at[0].add(bias)
        return {**jp, "logit": logit}
    gen = dict(jp["generator"])
    gen["b"] = gen["b"].at[0].add(bias)
    return {**jp, "generator": gen}


@pytest.mark.parametrize("name,beam,opts", [
    ("denseatt", 4, dict(group_size=2)),
    ("denseatt", 6, dict(group_size=3, decoding_constraint=True,
                         max_ppl=True)),
    ("denseatt", 4, dict(group_size=2, eos_bias=4.0)),
    ("denseatt", 3, dict(group_size=3, diversity_lambda=0.0)),
    ("transformer", 4, dict(group_size=2)),
    ("transformer", 6, dict(group_size=3, decoding_constraint=True,
                            max_ppl=True)),
], ids=["denseatt-g2", "denseatt-g3-constraint-max_ppl",
        "denseatt-g2-early-eos", "denseatt-g3-lambda0", "transformer-g2",
        "transformer-g3-constraint-max_ppl"])
def test_diverse_beam_matches_jax(pairs, name, beam, opts):
    jm, jp, jf, tf = pairs[name]
    opts = dict(opts)
    bias = opts.pop("eos_bias", 0.0)
    if bias:
        jp = _eos_biased(name, jp, bias)
    tm = _port(CFGS[name], jp)
    jr = jax.jit(lambda p, f: jm.sample_beam(p, f, beam_size=beam,
                                             **opts))(jp, jf)
    with torch.no_grad():
        tr = tm.sample_beam(tf, beam_size=beam, **opts)
    if bias:
        # every group's best beam ends on EOS before the cap
        assert (np.asarray(jr.seq)[:, ::beam // opts["group_size"], 0]
                == 0).all()
    np.testing.assert_array_equal(tr.seq.numpy(), np.asarray(jr.seq))
    np.testing.assert_allclose(tr.scores.numpy(), np.asarray(jr.scores),
                               atol=1e-5)
    np.testing.assert_allclose(tr.logps.numpy(), np.asarray(jr.logps),
                               atol=1e-5)
    if (opts.get("diversity_lambda", 0.5) and not opts.get("max_ppl")
            and not bias):
        # the penalty separates the groups' first tokens
        first = tr.seq[:, :, 0].reshape(B, opts["group_size"], -1)[:, :, 0]
        assert (first[:, 0] != first[:, 1]).any()


def test_grouped_selection_tie_order():
    """Equal values over [B, bd * V] come out by ascending index, as
    `lax.top_k` orders them."""
    rs = np.random.RandomState(1)
    x = rs.randint(0, 3, (4, 2 * 9)).astype(np.float32)
    tv, ti = row_topk(torch.from_numpy(x), 2)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 2)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
