"""PyTorch port, ops/sampling.py and `CaptionDecoder.sample`: greedy decoding
of the denseatt captioner against the JAX package's `model.sample(greedy=
True)` on the same parameters and numpy features (tokens identical,
logprobs within 1e-5), on the port's plain attention and with its
`SINGLE_KERNEL` or `STEP_FUSION` routes (their plain versions on the CPU);
multinomial sampling from a generator; scheduled sampling in `forward`; and
`CaptionService(greedy=True)`."""

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
from unpaired_image_captioning_tpu_torch.kernels import (
    additive_attention as aak)
from unpaired_image_captioning_tpu_torch.models import att as tatt
from unpaired_image_captioning_tpu_torch.models.base import Features
from unpaired_image_captioning_tpu_torch.serve import CaptionService
from unpaired_image_captioning_tpu_torch.utils.text import decode_sequence

torch.set_num_threads(1)
TOL = 1e-5
B, N, T = 4, 6, 8
CFG = Config(caption_model="denseatt", vocab_size=31, rnn_size=32,
             num_layers=1, input_encoding_size=16, att_hid_size=16,
             fc_feat_size=32, att_feat_size=24, seq_length=T,
             drop_prob_lm=0.0)
# raises the EOS logit of the random model (whose logits are nearly flat)
# so that two of the four rows end at once and two run to T
EOS_BIAS = 0.029


@pytest.fixture(scope="module")
def pair():
    jm = jmodels.setup(CFG)
    jp = jm.init_params(jax.random.PRNGKey(0))
    logit = [dict(jp["logit"][0])]
    logit[0]["b"] = logit[0]["b"].at[0].add(EOS_BIAS)
    jp = {**jp, "logit": logit}
    tm = tmodels.setup(CFG, device="cpu")
    tm.load_state_dict(bridge.params_from_jax(jp))
    rs = np.random.RandomState(0)
    fc = rs.randn(B, CFG.fc_feat_size).astype(np.float32)
    att = rs.randn(B, N, CFG.att_feat_size).astype(np.float32)
    masks = np.ones((B, N), np.float32)
    masks[1, 4:] = 0.0
    jf = JFeatures(fc_feats=jnp.asarray(fc), att_feats=jnp.asarray(att),
                   att_masks=jnp.asarray(masks))
    tf = Features(fc_feats=torch.from_numpy(fc),
                  att_feats=torch.from_numpy(att),
                  att_masks=torch.from_numpy(masks))
    jseq, jlp = jax.jit(lambda p, f: jm.sample(p, f, jax.random.PRNGKey(1),
                                               greedy=True))(jp, jf)
    return tm, tf, np.asarray(jseq), np.asarray(jlp)


@pytest.mark.parametrize("route", ["plain", "SINGLE_KERNEL", "STEP_FUSION"])
def test_greedy_matches_jax(pair, monkeypatch, route):
    tm, tf, jseq, jlp = pair
    calls = {"single": 0, "step": 0}
    for key, name in (("single", "additive_attention"),
                      ("step", "fused_att_lstm_att")):
        def spy(*a, _fn=getattr(aak, name), _key=key, **kw):
            calls[_key] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(aak, name, spy)
    if route != "plain":
        monkeypatch.setattr(tatt, route, True)
    seq, lp = tm.sample(tf)
    assert seq.dtype == torch.int64 and seq.shape == (B, T)
    np.testing.assert_array_equal(seq.numpy(), jseq)
    np.testing.assert_allclose(lp.numpy(), jlp, atol=TOL, rtol=TOL)
    # some rows finish early; the loop stops after the last row's EOS
    lengths = (seq > 0).sum(1)
    assert int(lengths.min()) < T and int(lengths.max()) > 0
    steps = min(T, int(lengths.max()) + 1)
    want = {"plain": {"single": 0, "step": 0},
            "SINGLE_KERNEL": {"single": 2 * steps, "step": 0},
            "STEP_FUSION": {"single": 0, "step": steps}}[route]
    assert calls == want


def test_sample_stops_once_every_row_has_finished():
    """Row r emits EOS at step r: the step function runs max(r) + 1 times,
    tokens stay 0 and logprobs 0 after each row's EOS."""
    from unpaired_image_captioning_tpu_torch.ops.sampling import sample

    calls = []

    def step_fn(state, it):
        t = len(calls)
        calls.append(it.clone())
        lp = torch.full((3, 5), -3.0)
        lp[:, 2] = -0.5
        lp[torch.arange(3) <= t, 0] = -0.1
        return lp, state

    seq, lp = sample(step_fn, None, 3, 10, device="cpu")
    assert len(calls) == 3
    assert seq.tolist() == [[0] * 10, [2] + [0] * 9, [2, 2] + [0] * 8]
    np.testing.assert_allclose(lp[2, :3].numpy(), [-0.5, -0.5, -0.1])
    assert not lp[2, 3:].any() and not lp[0, 1:].any()
    assert calls[0].tolist() == [0, 0, 0]          # the BOS feed


def test_multinomial_repeats_and_stays_finished(pair):
    tm, tf, _, _ = pair
    runs = []
    for _ in range(2):
        g = torch.Generator().manual_seed(3)
        runs.append(tm.sample(tf, greedy=False, temperature=0.8,
                              generator=g))
    torch.testing.assert_close(runs[0][0], runs[1][0], atol=0, rtol=0)
    torch.testing.assert_close(runs[0][1], runs[1][1], atol=0, rtol=0)
    seq, lp = runs[0]
    for row, lrow in zip(seq.numpy(), lp.numpy()):
        zeros = np.flatnonzero(row == 0)
        if len(zeros):
            assert not row[zeros[0]:].any()
            assert not lrow[zeros[0] + 1:].any()
    other = tm.sample(tf, greedy=False, generator=torch.Generator()
                      .manual_seed(4))[0]
    assert not torch.equal(other, seq)
    with pytest.raises(ValueError, match="generator"):
        tm.sample(tf, greedy=False)


def _labels(seed):
    seq = np.random.RandomState(seed).randint(
        1, CFG.vocab_size + 1, (B, T + 2)).astype(np.int64)
    seq[:, 0] = 0
    return torch.from_numpy(seq)


def test_scheduled_sampling_body_at_zero_equals_hoisted(pair):
    tm, tf, _, _ = pair
    seq = _labels(1)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        hoisted = tm.forward(tf, seq, training=True, generator=g)
        body = tm.forward(tf, seq, training=True, generator=g, ss_prob=0.0,
                          ss_enabled=True)
    torch.testing.assert_close(body, hoisted, atol=TOL, rtol=TOL)


def test_scheduled_sampling_keeps_bos_at_t0(pair):
    """At ss_prob = 1 every input after t = 0 is a draw from the previous
    step, so the labels past BOS do not matter, and step 0 is the
    teacher-forced one."""
    tm, tf, _, _ = pair
    with torch.no_grad():
        outs = [tm.forward(tf, _labels(s), training=True, ss_prob=1.0,
                           generator=torch.Generator().manual_seed(5))
                for s in (1, 2)]
        hoisted = tm.forward(tf, _labels(1))
    torch.testing.assert_close(outs[0], outs[1], atol=0, rtol=0)
    torch.testing.assert_close(outs[0][:, 0], hoisted[:, 0], atol=TOL,
                               rtol=TOL)
    assert not torch.allclose(outs[0][:, 1:], hoisted[:, 1:], atol=1e-3)
    with pytest.raises(ValueError, match="generator"):
        tm.forward(tf, _labels(1), training=True, ss_prob=0.5)


def test_greedy_caption_service(pair):
    tm, tf, jseq, _ = pair
    vocab = {str(i): f"w{i}" for i in range(1, CFG.vocab_size + 1)}
    svc = CaptionService(tm, vocab, greedy=True, max_batch=4)
    try:
        got = [svc.caption(tf.fc_feats[i].numpy(), tf.att_feats[i].numpy(),
                           tf.att_masks[i].numpy()) for i in range(B)]
    finally:
        svc.close()
    # one request per micro-batch: each image decodes alone, as in a batch
    assert got == decode_sequence(vocab, jseq)
    assert any(got)
