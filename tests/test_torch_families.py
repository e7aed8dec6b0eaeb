"""PyTorch port, the caption families of ROADMAP A10 (fc, TopDown, Att2in /
Att2in2 / Att2all2, AdaAtt / AdaAttMO, ShowTell, AllImg, ShowAttendTell
and StackCap's final head) against the JAX package on the same parameters
(carried over by `bridge.params_from_jax`) and the same seeded numpy
features, at V 31, H = E 32, 6 att slots (two images padded), L = 2 where
the family reads num_layers, dropout off:

- teacher-forced logprobs within 1e-5;
- greedy and beam-3 tokens identical, per-token logprobs and beam scores
  within 1e-4;
- the gradient of one XE loss (the trainer's `language_model_loss` over
  the forward) within 1e-5 for every parameter;
- `models.setup` builds every one of the JAX registry's 14 keys with the
  JAX tree's shapes, `Config()`'s default (fc) included, and `use_bn` 1 / 2
  for the AttModel families and the transformer;
- `Trainer.train` takes XE steps of each family with dropout on: finite,
  repeatable from the seed, falling on one batch.
"""

import numpy as np
import pytest
import torch

from unpaired_image_captioning_tpu_torch import bridge
from unpaired_image_captioning_tpu_torch import models as tmodels
from unpaired_image_captioning_tpu_torch.config import Config as TConfig
from unpaired_image_captioning_tpu_torch.kernels import lstm_cell as lk
from unpaired_image_captioning_tpu_torch.losses.criterion import (
    language_model_loss)
from unpaired_image_captioning_tpu_torch.models.base import Features
from unpaired_image_captioning_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)
B, N, V, T = 4, 6, 31, 8
FC, ATT, ATTRI = 24, 20, 7
FAMILIES = ["fc", "topdown", "att2in", "att2in2", "att2all2", "adaatt",
            "adaattmo", "show_tell", "all_img", "show_attend_tell",
            "stackcap"]
KW = dict(vocab_size=V, rnn_size=32, input_encoding_size=32,
          att_hid_size=16, fc_feat_size=FC, att_feat_size=ATT,
          attri_feat_size=ATTRI, seq_length=T, num_layers=2,
          drop_prob_lm=0.0)


def _np_inputs(seed=0):
    rs = np.random.RandomState(seed)
    fc = rs.randn(B, FC).astype(np.float32)
    att = rs.randn(B, N, ATT).astype(np.float32)
    attri = rs.rand(B, ATTRI).astype(np.float32)
    masks = np.ones((B, N), np.float32)
    masks[1, 4:] = 0.0                      # padded attention slots
    masks[3, 2:] = 0.0
    seq = rs.randint(1, V + 1, (B, T + 2)).astype(np.int64)
    seq[:, 0] = 0
    seq[2, 6:] = 0                          # a caption that ends early
    return fc, att, attri, masks, seq


_CACHE = {}


def _pair(family):
    """(JAX model, its params, the port's model on them, JAX feats, port
    feats, seq), one per family for the module."""
    if family in _CACHE:
        return _CACHE[family]
    import jax
    import jax.numpy as jnp

    from unpaired_image_captioning_tpu import models as jmodels
    from unpaired_image_captioning_tpu.config import Config
    from unpaired_image_captioning_tpu.models.base import Features as JF

    cfg = dict(KW, caption_model=family)
    jm = jmodels.setup(Config(**cfg))
    jp = jm.init_params(jax.random.PRNGKey(FAMILIES.index(family)))
    tm = tmodels.setup(TConfig(**cfg), device="cpu")
    tm.load_state_dict(bridge.params_from_jax(jp))
    fc, att, attri, masks, seq = _np_inputs()
    jf = JF(*(jnp.asarray(x) for x in (fc, att, attri, masks)))
    tf = Features(*(torch.from_numpy(x) for x in (fc, att, attri, masks)))
    _CACHE[family] = (jm, jp, tm, jf, tf, seq)
    return _CACHE[family]


def _last(out):
    return out[-1] if isinstance(out, list) else out


def _masks(seq):
    masks = (seq > 0).astype(np.float32)
    masks[:, :2] = 1.0
    return masks


_XE = {}


def _jax_xe(family):
    """JAX's teacher-forced logprobs, XE loss and its gradient, from one
    compiled `value_and_grad` a family."""
    if family not in _XE:
        import jax
        import jax.numpy as jnp

        from unpaired_image_captioning_tpu.losses import criterion as jcrit

        jm, jp, _, jf, _, seq = _pair(family)
        masks = _masks(seq)

        def loss_j(p):
            out = jm.forward(p, jf, jnp.asarray(seq, jnp.int32))
            return jcrit.language_model_loss(
                out, jnp.asarray(seq[:, 1:]), jnp.asarray(masks[:, 1:])), out

        (loss, out), grads = jax.jit(jax.value_and_grad(
            loss_j, has_aux=True))(jp)
        _XE[family] = (_last(out), loss, grads)
    return _XE[family]


@pytest.mark.parametrize("family", FAMILIES)
def test_forward_logprobs_match_jax(family):
    _, _, tm, _, tf, seq = _pair(family)
    jl = _jax_xe(family)[0]
    cells = lk.launches
    with torch.no_grad():
        tl = _last(tm.forward(tf, torch.from_numpy(seq)))
    assert lk.launches == cells            # the CPU runs the plain cell
    assert tl.shape == (B, T + 1, V + 1)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)


@pytest.mark.parametrize("family", FAMILIES)
def test_greedy_and_beam_match_jax(family):
    import jax

    jm, jp, tm, jf, tf, _ = _pair(family)
    js, jlp = jax.jit(lambda p, f: jm.sample(p, f, jax.random.PRNGKey(0)))(
        jp, jf)
    ts, tlp = tm.sample(tf, greedy=True)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), atol=1e-4)
    jr = jax.jit(lambda p, f: jm.sample_beam(p, f, beam_size=3))(jp, jf)
    with torch.no_grad():
        tr = tm.sample_beam(tf, beam_size=3)
    np.testing.assert_array_equal(tr.seq.numpy(), np.asarray(jr.seq))
    np.testing.assert_allclose(tr.scores.numpy(), np.asarray(jr.scores),
                               atol=1e-4)
    np.testing.assert_allclose(tr.logps.numpy(), np.asarray(jr.logps),
                               atol=1e-4)
    # the decodes differ across images: the check is not of one caption
    assert len({tuple(r) for r in ts.numpy()}) > 1


@pytest.mark.parametrize("family", FAMILIES)
def test_xe_gradient_matches_jax(family):
    _, _, tm, _, tf, seq = _pair(family)
    masks = _masks(seq)
    _, lj, gj = _jax_xe(family)
    names, ps = zip(*tm.named_parameters())
    lt = language_model_loss(tm.forward(tf, torch.from_numpy(seq)),
                             torch.from_numpy(seq[:, 1:]),
                             torch.from_numpy(masks[:, 1:]))
    gt = torch.autograd.grad(lt, ps, allow_unused=True)
    np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-6)
    want = bridge.params_from_jax(gj)
    assert set(want) == set(names)
    for name, p, g in zip(names, ps, gt):
        g = torch.zeros_like(p) if g is None else g
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=1e-5,
                                   err_msg=name)


JAX_KEYS = ["fc", "att2in", "att2in2", "att2all2", "adaatt", "adaattmo",
            "topdown", "stackatt", "denseatt", "transformer", "stackcap",
            "show_tell", "show_attend_tell", "all_img"]


@pytest.mark.parametrize("name", JAX_KEYS)
def test_setup_builds_every_jax_key(name):
    """Each key builds with the JAX tree's shapes; the AttModel families and
    the transformer with use_bn 1 and 2 as well."""
    import jax

    from unpaired_image_captioning_tpu import models as jmodels
    from unpaired_image_captioning_tpu.config import Config

    assert set(JAX_KEYS) == set(jmodels._REGISTRY) == set(tmodels._REGISTRY)
    with_bn = name not in ("fc", "show_tell", "all_img")
    for use_bn in ((0, 1, 2) if with_bn else (0,)):
        cfg = dict(KW, caption_model=name, use_bn=use_bn, num_heads=4)
        jp = jmodels.setup(Config(**cfg)).init_params(jax.random.PRNGKey(0))
        tm = tmodels.setup(TConfig(**cfg), device="cpu").init_params(
            torch.Generator().manual_seed(0))
        shapes_t = jax.tree_util.tree_map(np.shape,
                                          bridge.params_to_numpy(tm))
        assert shapes_t == jax.tree_util.tree_map(np.shape, jp), use_bn
        assert all(torch.isfinite(p).all() for p in tm.parameters())
        if use_bn and name not in ("att2in", "show_attend_tell"):
            assert ("bn1" in dict(tm.named_children())) == (use_bn == 2)


def test_default_config_builds_fc():
    m = tmodels.setup(TConfig(vocab_size=V), device="cpu")
    assert type(m).__name__ == "FCModel" and TConfig().caption_model == "fc"
    fresh = m.init_params(torch.Generator().manual_seed(0))
    # the logit is drawn at scale 0.1, as the JAX linear_init(scale=0.1)
    w = fresh.logit.w.detach()
    assert float(w.abs().max()) <= 0.1 and float(w.std()) > 0.04


def _batch(seed):
    fc, att, attri, masks, seq = _np_inputs(seed)
    return {"fc_feats": fc, "att_feats": att, "attri_feats": attri,
            "att_masks": masks, "labels": seq, "masks": _masks(seq)}


@pytest.mark.parametrize("family", FAMILIES)
def test_trainer_xe_steps_learn(family):
    runs = []
    for _ in range(2):
        tr = Trainer(TConfig(**dict(KW, caption_model=family,
                                    drop_prob_lm=0.3, i2t_learning_rate=1e-2,
                                    batch_size=B, seq_per_img=1,
                                    i2t_train_flag=True, seed=3)),
                     device="cpu")
        batch = _batch(1)
        runs.append([tr.train(batch)["total_loss"] for _ in range(4)])
    assert all(np.isfinite(runs[0]))
    assert runs[0] == runs[1]
    assert runs[0][-1] < runs[0][0]
