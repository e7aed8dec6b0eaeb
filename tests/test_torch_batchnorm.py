"""`use_bn` BatchNorm in the port (`models/att.py::batch_norm`,
`apply_bn_updates`, `calibrate_batch_norm`; the trainer's blend of the
running statistics; `cli.eval_paired --bn_calibrate`) against the JAX
package on the CPU, at tiny widths (V 20, widths 24, 6 att slots, batch 3),
on bridged parameters, dropout off:

- the running mean / var after 3 `Trainer.train` XE steps within 1e-6,
  and every other parameter within 1e-5, for TopDown at use_bn 2 (both
  BatchNorms) and the transformer at use_bn 1, with padded att slots and
  without (the moments count the real slots only);
- the parity trap of ROADMAP §C: `mean` / `var` are parameters as they
  are leaves of the JAX tree, so with weight decay the optimizer moves them
  (and the blend follows), and the SCST recompute (inference BatchNorm)
  gives them a gradient: both as JAX does, held over one step each;
- inference logprobs on non-trivial running statistics within 1e-5;
- `calibrate_batch_norm` against JAX's on the same batches within 1e-5;
- `cli.eval_paired --bn_calibrate 2` on a use_bn 2 run dir.
"""

import numpy as np
import pytest
import torch

from unpaired_image_captioning_tpu_torch import bridge
from unpaired_image_captioning_tpu_torch import models as tmodels
from unpaired_image_captioning_tpu_torch.config import Config as TConfig
from unpaired_image_captioning_tpu_torch.models import att as tatt
from unpaired_image_captioning_tpu_torch.models import transformer as ttr
from unpaired_image_captioning_tpu_torch.models.base import Features
from unpaired_image_captioning_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)
B, N, T, V = 3, 6, 5, 20
BASE = dict(vocab_size=V, input_encoding_size=24, rnn_size=24,
            att_hid_size=24, fc_feat_size=16, att_feat_size=16,
            seq_length=T, batch_size=B, seq_per_img=1, i2t_train_flag=True,
            i2t_max_grad_norm=5.0, i2t_learning_rate=5e-4, seed=7,
            drop_prob_lm=0.0, i2t_optim_epsilon=1e-6)
CASES = {
    "topdown-bn2": dict(BASE, caption_model="topdown", num_layers=1,
                        use_bn=2),
    "transformer-bn1": dict(BASE, caption_model="transformer", num_layers=2,
                            input_encoding_size=32, rnn_size=32,
                            num_heads=4, use_bn=1),
}


def _batch(seed=0, padded=True):
    rs = np.random.RandomState(seed)
    labels = np.zeros((B, T + 2), np.int64)
    masks = np.zeros((B, T + 2), np.float32)
    for i, n in enumerate((T, 3, 1)):
        labels[i, 1:1 + n] = rs.randint(1, V + 1, n)
        masks[i, :n + 2] = 1.0
    att_masks = np.ones((B, N), np.float32)
    if padded:
        att_masks[1, 4:] = 0.0
        att_masks[2, 1:] = 0.0
    return {"fc_feats": rs.randn(B, 16).astype(np.float32),
            "att_feats": (rs.randn(B, N, 16) * 2 + 1).astype(np.float32),
            "att_masks": att_masks, "labels": labels, "masks": masks}


def _trainers(tmp_path, monkeypatch, case, **extra):
    from unpaired_image_captioning_tpu.config import Config
    from unpaired_image_captioning_tpu.models import transformer as jtr
    from unpaired_image_captioning_tpu.train.trainer import Trainer as JT

    monkeypatch.setattr(jtr, "DROPOUT", 0.0)
    monkeypatch.setattr(ttr, "DROPOUT", 0.0)
    kw = dict(CASES[case], **extra)
    # dtype f32 on both sides: the trainers otherwise round the features
    # to bf16 (both defaults are "bfloat16")
    jt = JT(Config(**kw, dtype="float32", checkpoint_path=str(tmp_path)))
    pt = Trainer(TConfig(**kw, dtype="float32"), device="cpu")
    pt.i2t_model.load_state_dict(bridge.params_from_jax(jt.i2t_params))
    return jt, pt


def _same_params(pt, jt, tol):
    got = bridge.params_to_numpy(pt.i2t_model)
    want = jt.i2t_params
    for k in want:
        for name, w in bridge.params_from_jax({k: want[k]}).items():
            node = got
            for part in name.split("."):
                node = node[int(part) if isinstance(node, list) else part]
            t = 1e-6 if name.endswith((".mean", ".var")) else tol
            np.testing.assert_allclose(node, w.numpy(), rtol=t, atol=t,
                                       err_msg=name)


@pytest.mark.parametrize("padded", [True, False], ids=["padded", "full"])
@pytest.mark.parametrize("case", ["topdown-bn2", "transformer-bn1"])
def test_running_stats_after_three_steps_match_jax(tmp_path, monkeypatch,
                                                   case, padded):
    jt, pt = _trainers(tmp_path, monkeypatch, case)
    before = pt.i2t_model.bn0.mean.detach().clone()
    for step in range(3):
        batch = _batch(step, padded)
        jm, tm = jt.train(batch), pt.train(batch)
        np.testing.assert_allclose(tm["i2t_loss"], jm["i2t_loss"],
                                   rtol=1e-5, atol=1e-5)
    assert not torch.equal(pt.i2t_model.bn0.mean.detach(), before)
    _same_params(pt, jt, 1e-5)


def test_moments_count_real_slots_only():
    """The batch moments of a padded batch are those of its real rows."""
    x = torch.randn(3, 6, 5, generator=torch.Generator().manual_seed(0))
    mask = torch.ones(3, 6)
    mask[1, 4:] = 0.0
    aux = {}
    p = tatt.BatchNorm(5)
    p.init_params(None)
    tatt.batch_norm(p, x, True, mask=mask, aux_out=aux, key="bn0")
    real = x[mask > 0]
    mean, var = aux["bn0"]
    torch.testing.assert_close(mean, real.mean(0))
    torch.testing.assert_close(var, real.var(0, unbiased=True))


@pytest.mark.parametrize("what", ["weight_decay", "scst"])
def test_optimizer_moves_running_stats_as_jax(tmp_path, monkeypatch, what):
    """The parity trap: with weight decay the update moves `mean` / `var`
    (a zero gradient, but decayed weights); under SCST the recompute's
    inference BatchNorm gives them a real gradient. Both as in JAX."""
    import jax.numpy as jnp

    # SCST rewards from BLEU-4 alone (the default empty df table would
    # make every CIDEr-D reward 0)
    extra = ({"i2t_weight_decay": 0.1} if what == "weight_decay" else
             {"cider_reward_weight": 0.0, "bleu_reward_weight": 1.0})
    jt, pt = _trainers(tmp_path, monkeypatch, "topdown-bn2", **extra)
    # non-trivial running statistics in both
    for k, scale in (("bn0", 0.3), ("bn1", 0.2)):
        for leaf in ("mean", "var"):
            v = (np.random.RandomState(len(k + leaf)).rand(
                *jt.i2t_params[k][leaf].shape) * scale + 0.5).astype(
                np.float32)
            jt.i2t_params[k][leaf] = jnp.asarray(v)
            getattr(getattr(pt.i2t_model, k), leaf).data.copy_(
                torch.from_numpy(v))
    mean0 = pt.i2t_model.bn1.mean.detach().clone()
    batch = _batch(4)
    if what == "scst":
        # the samples repeat their references' words, the baseline not
        gen = batch["labels"][:, 1:T + 1].copy()
        gen[2, :3] = gen[0, :3]
        greedy = np.array([[3, 0, 0, 0, 0], [1, 2, 3, 0, 0], [4, 0, 0, 0, 0]])
        batch = dict(batch, gts=batch["labels"][:, None, 1:], gts_masks=(
            np.ones((B, 1), np.float32)))

        def pick(is_greedy):
            return greedy if is_greedy else gen

        monkeypatch.setattr(type(jt.i2t_model), "sample",
                            lambda self, p, f, rng, *, greedy=True, **_: (
                                jnp.asarray(pick(greedy), jnp.int32), None))
        monkeypatch.setattr(pt.i2t_model, "sample",
                            lambda feats, *, greedy=True, **_: (
                                torch.from_numpy(pick(greedy)), None))
        jm = jt.train(batch, sc_flag=True)
        tm = pt.train(batch, sc_flag=True)
    else:
        jm, tm = jt.train(batch), pt.train(batch)
    np.testing.assert_allclose(tm["total_loss"], jm["total_loss"], rtol=1e-5,
                               atol=1e-5)
    assert tm["total_loss"] != 0.0
    assert not torch.equal(pt.i2t_model.bn1.mean.detach(), mean0)
    _same_params(pt, jt, 1e-5)
    # the optimizer holds Adam moments for the running statistics too, by
    # name, as optax holds them for the tree's leaves
    mine = bridge.opt_state_from_optax(jt.optim.i2t_state)
    ours = pt.optim.i2t_state
    assert len(mine) == len(ours)
    for want, got in zip(mine, ours):
        assert set(want) == set(got)
        for field in set(want) - {"count"}:
            assert set(want[field]) == set(got[field])
            assert {"bn1.mean", "bn1.var", "bn0.mean"} <= set(got[field])
            for k, t in got[field].items():
                np.testing.assert_allclose(t.numpy(), want[field][k].numpy(),
                                           rtol=1e-4, atol=1e-9, err_msg=k)
    adam = next(d for d in ours if "mu" in d)
    moved = float(adam["mu"]["bn1.mean"].abs().max())
    assert (moved > 0) == (what == "scst")     # a gradient only under SCST


def _np_feats(seed=5, n=4):
    rs = np.random.RandomState(seed)
    masks = np.ones((n, N), np.float32)
    masks[0, 3:] = 0.0
    return (rs.randn(n, 16).astype(np.float32),
            (rs.randn(n, N, 16) * 2 + 1).astype(np.float32), masks)


@pytest.mark.parametrize("case", ["topdown-bn2", "transformer-bn1"])
def test_inference_uses_running_stats_as_jax(case):
    import jax
    import jax.numpy as jnp

    from unpaired_image_captioning_tpu import models as jmodels
    from unpaired_image_captioning_tpu.config import Config
    from unpaired_image_captioning_tpu.models.base import Features as JF

    cfg = CASES[case]
    jm = jmodels.setup(Config(**cfg))
    jp = jm.init_params(jax.random.PRNGKey(1))
    rs = np.random.RandomState(2)
    for k in ("bn0", "bn1"):
        if k in jp:
            d = jp[k]["mean"].shape[0]
            jp[k] = {"scale": jnp.asarray(rs.rand(d) + 0.5),
                     "offset": jnp.asarray(rs.randn(d) * 0.1),
                     "mean": jnp.asarray(rs.randn(d)),
                     "var": jnp.asarray(rs.rand(d) + 0.5)}
    jp = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), jp)
    tm = tmodels.setup(TConfig(**cfg), device="cpu")
    tm.load_state_dict(bridge.params_from_jax(jp))
    fc, att, masks = _np_feats()
    seq = np.random.RandomState(3).randint(1, V + 1, (4, T + 2))
    seq[:, 0] = 0
    jl = jm.forward(jp, JF(jnp.asarray(fc), jnp.asarray(att), None,
                           jnp.asarray(masks)), jnp.asarray(seq))
    with torch.no_grad():
        tl = tm.forward(Features(torch.from_numpy(fc), torch.from_numpy(att),
                                 None, torch.from_numpy(masks)),
                        torch.from_numpy(seq))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)


class _Loader:
    """get_batch(split) of seeded numpy att features and masks."""

    def __init__(self):
        self.rs = np.random.RandomState(9)

    def get_batch(self, split):
        masks = np.ones((B, N), np.float32)
        masks[self.rs.randint(B), self.rs.randint(1, N):] = 0.0
        return {"att_feats": (self.rs.randn(B, N, 16) * 3 - 1).astype(
            np.float32), "att_masks": masks}


@pytest.mark.parametrize("case", ["topdown-bn2", "transformer-bn1"])
def test_calibrate_batch_norm_matches_jax(case):
    import jax

    from unpaired_image_captioning_tpu import models as jmodels
    from unpaired_image_captioning_tpu.config import Config
    from unpaired_image_captioning_tpu.models.att import (
        calibrate_batch_norm as jcal)

    cfg = CASES[case]
    jp = jmodels.setup(Config(**cfg)).init_params(jax.random.PRNGKey(4))
    tm = tmodels.setup(TConfig(**cfg), device="cpu")
    tm.load_state_dict(bridge.params_from_jax(jp))
    want = jcal(jp, _Loader(), n_batches=3)
    assert tatt.calibrate_batch_norm(tm, _Loader(), n_batches=3) is tm
    got = bridge.params_to_numpy(tm)
    for k in ("bn0", "bn1"):
        if k in want:
            for leaf in ("mean", "var"):
                np.testing.assert_allclose(got[k][leaf],
                                           np.asarray(want[k][leaf]),
                                           rtol=1e-5, atol=1e-5,
                                           err_msg=f"{k}.{leaf}")
    assert float(tm.bn0.var.detach().mean()) > 5.0      # the data's, not 1
    # a model without BatchNorm is left alone
    plain = tmodels.setup(TConfig(**dict(cfg, use_bn=0)), device="cpu")
    assert tatt.calibrate_batch_norm(plain, _Loader()) is plain


def test_eval_paired_bn_calibrate(tmp_path, monkeypatch):
    """`--bn_calibrate 2` on a use_bn 2 TopDown run dir: the running
    statistics the eval runs on are those of `calibrate_batch_norm` over
    two train batches of the run's loader."""
    from unpaired_image_captioning_tpu_torch.cli import eval_paired
    from unpaired_image_captioning_tpu_torch.cli import train as tcli
    from unpaired_image_captioning_tpu_torch.data import synthetic as tsyn
    from unpaired_image_captioning_tpu_torch.train.checkpoint import (
        CheckpointManager)

    monkeypatch.chdir(tmp_path)
    jpath, label, mem = tsyn.make_caption_artifacts(
        str(tmp_path), vocab_size=V, seq_length=T, caps_per_img=2,
        fc_dim=16, att_dim=16, seed=3)
    fc_dir, att_dir = tsyn.write_feature_dirs(str(tmp_path), mem)
    data = dict(input_json=jpath, input_label_h5=label, input_fc_dir=fc_dir,
                input_att_dir=att_dir, batch_size=2, seq_per_img=2)
    run = str(tmp_path / "run")
    args = dict(data, caption_model="topdown", use_bn=2, rnn_size=24,
                input_encoding_size=24, att_hid_size=24, fc_feat_size=16,
                att_feat_size=16, num_layers=1, i2t_train_flag="true",
                max_epochs=1, save_checkpoint_every=1000, language_eval=0,
                checkpoint_path=run, id="run", device="cpu")
    tcli.main([x for k, v in args.items() for x in ("--" + k, str(v))])
    seen = {}
    cal = tatt.calibrate_batch_norm

    def spy(model, loader, **kw):
        out = cal(model, loader, **kw)
        seen["stats"] = {k: v.detach().clone()
                         for k, v in model.state_dict().items()
                         if k.startswith("bn")}
        seen["kw"] = kw
        return out

    monkeypatch.setattr(tatt, "calibrate_batch_norm", spy)
    ev = dict(data, start_from=run, load_best_score=0, beam_size=2,
              id="eval", device="cpu", bn_calibrate=2)
    out = eval_paired.main([x for k, v in ev.items()
                            for x in ("--" + k, str(v))])
    assert seen["kw"] == {"n_batches": 2}
    trained = CheckpointManager(run).load_params("model_i2t")
    assert not torch.equal(seen["stats"]["bn0.var"], trained["bn0.var"])
    assert out["predictions"] and np.isfinite(out["loss"])
