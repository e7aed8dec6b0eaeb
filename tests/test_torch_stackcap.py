"""StackCap in the port (`models/stackcap.py`) against the JAX package on
the CPU, on bridged parameters at V 31, H = E 32, 6 att slots (padded),
1,601 -> 7 attributes, dropout off:

- the three teacher-forced heads (coarse, fine, final) within 1e-5 each,
  and the XE loss that sums them;
- a missing `attri_feats` decodes as zeros, as in JAX;
- the SCST recompute reads the final head: `Trainer._rl_loss` on given
  sequences, its loss and every gradient against `jax.value_and_grad` of
  JAX's recompute (rtol 1e-5 / atol 1e-5);
- scheduled sampling trains through the three-headed loop;
- `bilinear_d3_*` and `sentence_attention_*` against JAX within 1e-5.
"""

import numpy as np
import pytest
import torch

from unpaired_image_captioning_tpu_torch import bridge
from unpaired_image_captioning_tpu_torch import models as tmodels
from unpaired_image_captioning_tpu_torch.config import Config as TConfig
from unpaired_image_captioning_tpu_torch.losses import criterion as tcrit
from unpaired_image_captioning_tpu_torch.models import stackcap as tsc
from unpaired_image_captioning_tpu_torch.models.base import Features
from unpaired_image_captioning_tpu_torch.train import trainer as ttrainer
from unpaired_image_captioning_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)
B, N, V, T = 4, 6, 31, 8
KW = dict(caption_model="stackcap", vocab_size=V, rnn_size=32,
          input_encoding_size=32, att_hid_size=16, fc_feat_size=24,
          att_feat_size=20, attri_feat_size=7, seq_length=T, num_layers=1,
          drop_prob_lm=0.0)


@pytest.fixture(scope="module")
def pair():
    import jax
    import jax.numpy as jnp

    from unpaired_image_captioning_tpu import models as jmodels
    from unpaired_image_captioning_tpu.config import Config
    from unpaired_image_captioning_tpu.models.base import Features as JF

    jm = jmodels.setup(Config(**KW))
    jp = jm.init_params(jax.random.PRNGKey(5))
    tm = tmodels.setup(TConfig(**KW), device="cpu")
    tm.load_state_dict(bridge.params_from_jax(jp))
    rs = np.random.RandomState(0)
    fc = rs.randn(B, 24).astype(np.float32)
    att = rs.randn(B, N, 20).astype(np.float32)
    attri = rs.rand(B, 7).astype(np.float32)
    masks = np.ones((B, N), np.float32)
    masks[2, 3:] = 0.0
    seq = rs.randint(1, V + 1, (B, T + 2)).astype(np.int64)
    seq[:, 0] = 0
    np_in = dict(fc=fc, att=att, attri=attri, masks=masks, seq=seq)

    def jf(with_attri=True):
        return JF(jnp.asarray(fc), jnp.asarray(att),
                  jnp.asarray(attri) if with_attri else None,
                  jnp.asarray(masks))

    def tf(with_attri=True):
        return Features(torch.from_numpy(fc), torch.from_numpy(att),
                        torch.from_numpy(attri) if with_attri else None,
                        torch.from_numpy(masks))

    return jm, jp, tm, jf, tf, np_in


def test_three_heads_and_loss_match_jax(pair):
    import jax.numpy as jnp

    from unpaired_image_captioning_tpu.losses import criterion as jcrit

    jm, jp, tm, jf, tf, d = pair
    seq = d["seq"]
    masks = np.ones(seq.shape, np.float32)
    jl = jm.forward(jp, jf(), jnp.asarray(seq, jnp.int32))
    with torch.no_grad():
        tl = tm.forward(tf(), torch.from_numpy(seq))
    assert isinstance(tl, list) and len(tl) == 3
    for k, (a, b) in enumerate(zip(tl, jl)):
        assert a.shape == (B, T + 1, V + 1)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   err_msg=f"head {k}")
    # the heads differ: the loss is a sum of three distinct terms
    assert float((tl[0] - tl[2]).abs().max()) > 1e-3
    lt = tcrit.language_model_loss(tl, torch.from_numpy(seq[:, 1:]),
                                   torch.from_numpy(masks[:, 1:]))
    lj = jcrit.language_model_loss(jl, jnp.asarray(seq[:, 1:]),
                                   jnp.asarray(masks[:, 1:]))
    np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-6)


def test_missing_attributes_are_zeros(pair):
    import jax

    jm, jp, tm, jf, tf, d = pair
    zeros = tf()._replace(attri_feats=torch.zeros(B, 7))
    with torch.no_grad():
        a = tm.sample_beam(tf(with_attri=False), beam_size=3)
        b = tm.sample_beam(zeros, beam_size=3)
    assert torch.equal(a.seq, b.seq) and torch.equal(a.scores, b.scores)
    jr = jax.jit(lambda p, f: jm.sample_beam(p, f, beam_size=3))(
        jp, jf(with_attri=False))
    np.testing.assert_array_equal(a.seq.numpy(), np.asarray(jr.seq))


def test_scst_recompute_reads_the_final_head(pair, monkeypatch):
    import jax
    import jax.numpy as jnp

    from unpaired_image_captioning_tpu.losses import criterion as jcrit

    jm, jp, tm, jf, tf, d = pair
    gen = d["seq"][:, 1:T + 1].copy()
    gen[1, 3:] = 0
    gen[3, 5:] = 0
    adv = np.array([1.0, -0.5, 2.0, 0.7], np.float32)

    def loss_j(p):
        seq_full = jnp.concatenate([jnp.zeros((B, 1), jnp.int32),
                                    jnp.asarray(gen, jnp.int32)], 1)
        out = jm.forward(p, jf(), seq_full, training=False)[-1]
        lp = jnp.take_along_axis(out, jnp.asarray(gen, jnp.int32)[..., None],
                                 axis=-1)[..., 0]
        return jcrit.reward_loss(lp, jnp.asarray(gen), jnp.asarray(adv))

    lj, gj = jax.jit(jax.value_and_grad(loss_j))(jp)
    tr = Trainer(TConfig(**KW, batch_size=B, seq_per_img=1,
                         i2t_train_flag=True), device="cpu")
    tr.i2t_model.load_state_dict(tm.state_dict())
    # the trainer's recompute, with the advantage given
    monkeypatch.setattr(ttrainer, "get_self_critical_reward",
                        lambda *a, **kw: (torch.from_numpy(adv),
                                          torch.from_numpy(adv)))
    lt, _ = tr._rl_loss(tf(), torch.from_numpy(gen),
                        torch.zeros_like(torch.from_numpy(gen)),
                        torch.zeros((B, 1, 3), dtype=torch.long),
                        torch.ones((B, 1)))
    names, ps = zip(*tr.i2t_model.named_parameters())
    gt = torch.autograd.grad(lt, ps, allow_unused=True)
    np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-5)
    want = bridge.params_from_jax(gj)
    for name, p, g in zip(names, ps, gt):
        g = torch.zeros_like(p) if g is None else g
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def test_scheduled_sampling_trains():
    tr = Trainer(TConfig(**dict(KW, drop_prob_lm=0.3, batch_size=B,
                                seq_per_img=1, i2t_train_flag=True,
                                scheduled_sampling_start=0)), device="cpu")
    tr.epoch = 10                     # ss_prob 0.1 on the default schedule
    rs = np.random.RandomState(3)
    labels = rs.randint(1, V + 1, (B, T + 2))
    labels[:, 0] = 0
    batch = {"fc_feats": rs.randn(B, 24).astype(np.float32),
             "att_feats": rs.randn(B, N, 20).astype(np.float32),
             "attri_feats": rs.rand(B, 7).astype(np.float32),
             "att_masks": np.ones((B, N), np.float32), "labels": labels,
             "masks": np.ones((B, T + 2), np.float32)}
    out = [tr.train(batch) for _ in range(3)]
    assert out[0]["ss_prob"] == pytest.approx(0.1)
    assert all(np.isfinite(o["total_loss"]) for o in out)
    assert out[-1]["total_loss"] < out[0]["total_loss"]


def test_auxiliary_modules_match_jax():
    import jax
    import jax.numpy as jnp

    from unpaired_image_captioning_tpu.models import stackcap as jsc

    rs = np.random.RandomState(1)
    x = rs.randn(3, 8).astype(np.float32)
    y = rs.randn(3, 5, 6).astype(np.float32)
    jb = jsc.bilinear_d3_init(jax.random.PRNGKey(0), 8, 6)
    tb = tsc.bilinear_d3_init(8, 6)
    tb.load_state_dict(bridge.params_from_jax(jb))
    np.testing.assert_allclose(
        tsc.bilinear_d3_apply(tb, torch.from_numpy(x),
                              torch.from_numpy(y)).detach().numpy(),
        np.asarray(jsc.bilinear_d3_apply(jb, jnp.asarray(x),
                                         jnp.asarray(y))), atol=1e-5)
    fresh = tsc.bilinear_d3_init(8, 6)
    fresh.init_params(torch.Generator().manual_seed(0))
    assert float(fresh.w.detach().abs().max()) <= 8 ** -0.5
    hist = rs.randn(3, 5, 8).astype(np.float32)
    h = rs.randn(3, 8).astype(np.float32)
    mask = np.ones((3, 5), np.float32)
    mask[1, 2:] = 0.0
    js = jsc.sentence_attention_init(jax.random.PRNGKey(1), 8, 4)
    ts = tsc.sentence_attention_init(8, 4)
    ts.load_state_dict(bridge.params_from_jax(js))
    with torch.no_grad():
        got = tsc.sentence_attention_apply(ts, torch.from_numpy(h),
                                           torch.from_numpy(hist),
                                           torch.from_numpy(mask))
    want = jsc.sentence_attention_apply(js, jnp.asarray(h),
                                        jnp.asarray(hist), jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
