"""The port's optimizer (`train/optimizer.py`) against the JAX package's
optax chains: the six methods over 3 steps, with the global-norm clip
active (gradients above the bound) and idle (below it), weight decay on
one case; the learning-rate and scheduled-sampling schedules, the plateau
scheduler and `DualOptim`. Tolerance 1e-6 relative (f32 elementwise
arithmetic in another order).
"""

import numpy as np
import pytest
import torch

from unpaired_image_captioning_tpu_torch.config import Config as TConfig
from unpaired_image_captioning_tpu_torch.train import optimizer as topt

SHAPES = {"a.w": (4, 3), "a.b": (3,), "b.0.w": (5,)}
METHODS = ("adam", "rmsprop", "adagrad", "sgd", "sgdm", "sgdmom")
CASES = ([(m, clip, 0.0) for m in METHODS for clip in ("above", "below")]
         + [("adam", "above", 0.01), ("schedules", None, 0.0),
            ("dual_optim", None, 0.0)])


def _check_transform(method, clip, weight_decay):
    from unpaired_image_captioning_tpu.train import optimizer as jopt
    from unpaired_image_captioning_tpu_torch import bridge

    rs = np.random.RandomState(METHODS.index(method))
    params = {k: rs.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    # global norm about 5.5 per unit scale: clip 1.0 is active, 100.0 idle
    max_norm = 1.0 if clip == "above" else 100.0
    kw = dict(alpha=0.9, beta=0.999, eps=1e-8, momentum=0.9,
              max_grad_norm=max_norm, weight_decay=weight_decay)
    jtx = jopt.make_transform(method, **kw)
    ttx = topt.make_transform(method, **kw)
    def tree(flat):
        return bridge.tree_from_flat({k: torch.from_numpy(np.asarray(v))
                                      for k, v in flat.items()})

    jflat = dict(params)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jtx.init(tree(jflat)), ttx.init(tp)
    for step in range(3):
        grads = {k: (rs.randn(*s) * (step + 1)).astype(np.float32)
                 for k, s in SHAPES.items()}
        ju, js = jtx.update(tree(grads), js, tree(jflat))
        tu, ts = ttx.update({k: torch.from_numpy(v) for k, v in grads.items()},
                            ts, tp)
        ju = {k: v.numpy() for k, v in bridge.params_from_jax(ju).items()}
        for k in SHAPES:
            np.testing.assert_allclose(tu[k].numpy(), ju[k], rtol=1e-6,
                                       atol=1e-7, err_msg=k)
        jflat = {k: jflat[k] - np.float32(0.1) * ju[k] for k in SHAPES}
        tp = {k: tp[k] - 0.1 * tu[k] for k in tp}
    mine = bridge.opt_state_from_optax(js)
    for part_j, part_t in zip(mine, ts):
        assert set(part_j) == set(part_t)
        for name, value in part_t.items():
            if name == "count":
                assert value == part_j[name] == 3
                continue
            for k in SHAPES:
                np.testing.assert_allclose(value[k].numpy(),
                                           part_j[name][k].numpy(),
                                           rtol=1e-6, atol=1e-7)


def _check_schedules():
    from unpaired_image_captioning_tpu.train import optimizer as jopt

    for args in ((5e-4, 0, -1, 3, 0.8), (5e-4, 7, 2, 3, 0.8),
                 (1.0, 9, 0, 2, 0.5)):
        assert topt.epoch_decayed_lr(*args) == jopt.epoch_decayed_lr(*args)
    for step in (0, 1, 50, 4000, 9000):
        assert topt.noam_lr(512, 2.0, 4000, step) == jopt.noam_lr(
            512, 2.0, 4000, step)
    for epoch in (0, 4, 10, 40):
        args = (epoch, 2, 5, 0.05, 0.25)
        assert (topt.scheduled_sampling_prob(*args)
                == jopt.scheduled_sampling_prob(*args))
    jp, tp = jopt.PlateauScheduler(patience=1), topt.PlateauScheduler(
        patience=1)
    for metric in (1.0, 0.5, 0.4, 2.0, 1.0, 1.0, 1.0):
        assert tp.update(metric) == jp.update(metric)


def _check_dual_optim():
    from unpaired_image_captioning_tpu.config import Config
    from unpaired_image_captioning_tpu.train import optimizer as jopt

    kw = dict(i2t_learning_rate_decay_start=2, nmt_decay_method="noam",
              nmt_learning_rate=2.0, scheduled_sampling_start=0)
    jd = jopt.DualOptim(Config(**kw))
    td = topt.DualOptim(TConfig(**kw), {"w": torch.zeros(3)})
    assert td.i2t_state[0] == {} and td.i2t_state[1]["count"] == 0
    assert td.nmt_state is None
    for epoch in range(8):
        jd.nmt_step = td.nmt_step = epoch * 100
        assert td.i2t_lr(epoch) == jd.i2t_lr(epoch)
        assert td.nmt_lr(epoch) == jd.nmt_lr(epoch)
        assert td.ss_prob(epoch) == jd.ss_prob(epoch)


@pytest.mark.parametrize("method,clip,weight_decay", CASES)
def test_optimizer_matches_optax(method, clip, weight_decay):
    if method == "schedules":
        _check_schedules()
    elif method == "dual_optim":
        _check_dual_optim()
    else:
        _check_transform(method, clip, weight_decay)


@pytest.mark.parametrize("method", METHODS)
def test_clip_alone_reads_the_given_whole_gradient_norm(method):
    """`global_sq_norm` (the squared norm of the whole gradient, of which
    `grads` holds one rank's shards) reaches the clip and no other part of
    the chain: the update equals the unclipped chain's on the gradient
    scaled by max_norm / that norm, with weight decay after the method."""
    rs = np.random.RandomState(5)
    params = {k: torch.from_numpy(rs.randn(*s).astype(np.float32))
              for k, s in SHAPES.items()}
    # the shard's own norm is below the bound, the whole one far above
    grads = {k: 0.01 * torch.ones_like(p) for k, p in params.items()}
    whole = torch.tensor(16.0)
    kw = dict(momentum=0.9, weight_decay=0.01)
    tx = topt.make_transform(method, max_grad_norm=0.5, **kw)
    plain = topt.make_transform(method, **kw)
    got, _ = tx.update(grads, tx.init(params), params, global_sq_norm=whole)
    want, _ = plain.update({k: g / 4.0 * 0.5 for k, g in grads.items()},
                           plain.init(params), params)
    for k in params:
        torch.testing.assert_close(got[k], want[k], rtol=1e-6, atol=1e-7)
    # without it, the clip reads the shard's own norm and stays idle
    idle, _ = tx.update(grads, tx.init(params), params)
    same, _ = plain.update(grads, plain.init(params), params)
    for k in params:
        torch.testing.assert_close(idle[k], same[k], rtol=0, atol=0)
