"""PyTorch port, the BiLSTM NMT: encoder context and final states under
ragged source lengths (atol 1e-5, f32), and the OpenNMT beam translate at
beam 5 and 15 (identical tokens and aux, scores atol 1e-4), against the JAX
package on the same parameters and inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unpaired_image_captioning_tpu import constants as C
from unpaired_image_captioning_tpu.models.nmt import NMTModel as JNMTModel
from unpaired_image_captioning_tpu_torch import bridge
from unpaired_image_captioning_tpu_torch.models.nmt import NMTModel

torch.set_num_threads(1)

SRC_V, TGT_V, B, S = 31, 29, 4, 7
KW = dict(src_vocab_size=SRC_V, tgt_vocab_size=TGT_V, word_vec_size=16,
          rnn_size=24, layers=1, dropout=0.3, max_decode_len=8)


@pytest.fixture(scope="module")
def pair():
    jm = JNMTModel(**KW)
    jp = jm.init_params(jax.random.PRNGKey(1))
    tm = NMTModel(**KW)
    tm.load_state_dict(bridge.params_from_jax(jp))
    rs = np.random.RandomState(2)
    lengths = np.array([S, S - 2, 3, 1], np.int32)
    src = rs.randint(4, SRC_V, (B, S)).astype(np.int32)
    src[np.arange(S)[None, :] >= lengths[:, None]] = C.PAD
    return jm, jp, tm, src, lengths


def test_encoder_matches_jax(pair):
    jm, jp, tm, src, lengths = pair
    jctx, (jh, jc) = jm.encoder.apply(jp["encoder"], jnp.asarray(src),
                                      jnp.asarray(lengths))
    with torch.no_grad():
        tctx, (th, tc) = tm.encoder.apply(torch.from_numpy(src).long(),
                                          torch.from_numpy(lengths).long())
    assert tctx.shape == (B, S, KW["rnn_size"])
    assert th.shape == (1, B, KW["rnn_size"])
    np.testing.assert_allclose(tctx.numpy(), np.asarray(jctx), atol=1e-5)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-5)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
    # padded positions are exactly zero in both directions
    assert float(tctx[3, 1:].abs().max()) == 0.0


def test_decoder_step_matches_jax(pair):
    jm, jp, tm, src, lengths = pair
    jctx, jhid = jm.encoder.apply(jp["encoder"], jnp.asarray(src),
                                  jnp.asarray(lengths))
    mask = (np.arange(S)[None, :] < lengths[:, None]).astype(np.float32)
    jst = jm.decoder.init_state(jhid, jctx)
    it = np.array([C.BOS, 5, 9, C.BOS], np.int32)
    jout, jattn, _ = jm.decoder.step(jp["decoder"], jctx, jst,
                                     jnp.asarray(it),
                                     src_mask=jnp.asarray(mask))
    with torch.no_grad():
        tctx, thid = tm.encoder.apply(torch.from_numpy(src).long(),
                                      torch.from_numpy(lengths).long())
        tst = tm.decoder.init_state(thid, tctx)
        tout, tattn, _ = tm.decoder.step(tctx, tst,
                                         torch.from_numpy(it).long(),
                                         src_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=1e-5)
    np.testing.assert_allclose(tattn.numpy(), np.asarray(jattn), atol=1e-5)


@pytest.mark.parametrize("beam,eos_bias", [(5, 0.0), (15, 0.0), (5, 2.5)],
                         ids=["beam5", "beam15", "beam5-early-eos"])
def test_translate_batch_matches_jax(pair, beam, eos_bias):
    """eos_bias raises the generator's EOS logit so that sentences finish
    (EOS on top of the beam) and freeze before the length cap."""
    jm, jp, tm, src, lengths = pair
    if eos_bias:
        gen = dict(jp["generator"])
        gen["b"] = gen["b"].at[C.EOS].add(eos_bias)
        jp = {**jp, "generator": gen}
        tm = NMTModel(**KW)
        tm.load_state_dict(bridge.params_from_jax(jp))
    jr = jax.jit(lambda p, s, l: jm.translate_batch(p, s, l, beam_size=beam))(
        jp, jnp.asarray(src), jnp.asarray(lengths))
    if eos_bias:
        assert (np.asarray(jr.seq)[:, 0] == C.EOS).any(axis=1).all()
    with torch.no_grad():
        tr = tm.translate_batch(torch.from_numpy(src).long(),
                                torch.from_numpy(lengths).long(),
                                beam_size=beam)
    np.testing.assert_array_equal(tr.seq.numpy(), np.asarray(jr.seq))
    np.testing.assert_array_equal(tr.aux.numpy(), np.asarray(jr.aux))
    np.testing.assert_allclose(tr.scores.numpy(), np.asarray(jr.scores),
                               atol=1e-4)


def test_init_params_shapes_match_jax(pair):
    _, jp, _, _, _ = pair
    fresh = NMTModel(**KW).init_params(torch.Generator().manual_seed(0))
    back = bridge.params_to_numpy(fresh)
    assert (jax.tree_util.tree_map(np.shape, back)
            == jax.tree_util.tree_map(np.shape, jp))
    lut = fresh.encoder.embeddings.word_lut.detach()
    assert float(lut[C.PAD].abs().max()) == 0.0


@pytest.mark.parametrize("flag", [dict(copy_attn=True),
                                  dict(coverage_attn=True),
                                  dict(context_gate="both"),
                                  dict(attention_type="mlp"),
                                  dict(attn_transform="sparsemax")])
def test_unported_options_raise(pair, flag):
    """The five options that raised before they were ported now build and
    match JAX: teacher-forced outputs and attentions within 1e-5."""
    _, _, _, src, lengths = pair
    jm = JNMTModel(**{**KW, **flag, "dropout": 0.0})
    jp = jm.init_params(jax.random.PRNGKey(3))
    tm = NMTModel(**{**KW, **flag, "dropout": 0.0}, device="cpu")
    tm.load_state_dict(bridge.params_from_jax(jp))
    tgt = np.random.RandomState(4).randint(4, TGT_V, (B, 5)).astype(np.int32)
    tgt[:, 0] = C.BOS
    jouts, jatt = jax.jit(lambda p: jm.forward(
        p, jnp.asarray(src), jnp.asarray(lengths), jnp.asarray(tgt)))(jp)
    with torch.no_grad():
        outs, att = tm.forward(torch.from_numpy(src).long(),
                               torch.from_numpy(lengths).long(),
                               torch.from_numpy(tgt).long())
    if flag.get("copy_attn"):
        (att, copy), (jatt, jcopy) = att, jatt
        np.testing.assert_allclose(copy.numpy(), np.asarray(jcopy),
                                   atol=1e-5)
    np.testing.assert_allclose(outs.numpy(), np.asarray(jouts), atol=1e-5)
    np.testing.assert_allclose(att.numpy(), np.asarray(jatt), atol=1e-5)
