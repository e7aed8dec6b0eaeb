"""The port's XE training step of the denseatt captioner
(`train/trainer.py`) against the JAX `Trainer` at tiny widths (V 20, rnn /
input encoding / attention hidden 24, 6 att slots, seq_length 5, batch 3),
Adam with the global-norm clip: with every dropout at 0, the losses of
steps 1 and 2 and the parameters and Adam moments after step 2 agree within
1e-5, with the port's `TRAIN_KERNEL` off (plain attention, with the
alpha_net bias) and on (the single-query attention kernel's plain version,
without it; the JAX Trainer runs its XLA route on the CPU either way). With
dropout on, the loss is finite, repeats exactly from the same seed and
falls over 5 steps on one batch; scheduled sampling trains too.

Adam's eps is 1e-6 as in the transformer's parity test: the alpha_net bias
has a gradient that is zero in exact arithmetic (a softmax row is
shift-invariant), so each framework feeds Adam its own rounding noise
there, or, on the kernel route, no gradient at all.
"""

import numpy as np
import pytest
import torch

from unpaired_image_captioning_tpu_torch import bridge
from unpaired_image_captioning_tpu_torch.config import Config as TConfig
from unpaired_image_captioning_tpu_torch.kernels import (
    additive_attention as aak)
from unpaired_image_captioning_tpu_torch.kernels import lstm_cell as lk
from unpaired_image_captioning_tpu_torch.models import att as tatt
from unpaired_image_captioning_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)
B, N, T, V = 3, 6, 5, 20
TOL = 1e-5
CFG = dict(caption_model="denseatt", vocab_size=V, input_encoding_size=24,
           rnn_size=24, num_layers=1, fc_feat_size=16, att_feat_size=16,
           att_hid_size=24, seq_length=T, batch_size=B, seq_per_img=1,
           i2t_train_flag=True, i2t_max_grad_norm=5.0,
           i2t_learning_rate=5e-4, seed=7)


def _batch(seed=0):
    rs = np.random.RandomState(seed)
    labels = np.zeros((B, T + 2), np.int64)
    masks = np.zeros((B, T + 2), np.float32)
    for i, n in enumerate((T, 3, 1)):
        labels[i, 1:1 + n] = rs.randint(1, V + 1, n)
        masks[i, :n + 2] = 1.0
    att_masks = np.ones((B, N), np.float32)
    att_masks[1, 4:] = 0.0
    return {"fc_feats": rs.randn(B, 16).astype(np.float32),
            "att_feats": rs.randn(B, N, 16).astype(np.float32),
            "att_masks": att_masks, "labels": labels, "masks": masks}


@pytest.mark.parametrize("train_kernel", [False, True],
                         ids=["plain", "train_kernel"])
def test_xe_steps_match_jax_trainer(tmp_path, monkeypatch, train_kernel):
    import jax

    from unpaired_image_captioning_tpu.config import Config
    from unpaired_image_captioning_tpu.train.trainer import Trainer as JT

    monkeypatch.setattr(tatt, "TRAIN_KERNEL", train_kernel)
    calls = []

    def spy(*a, _fn=aak.additive_attention, **kw):
        calls.append(1)
        return _fn(*a, **kw)

    monkeypatch.setattr(aak, "additive_attention", spy)
    kw = dict(CFG, drop_prob_lm=0.0, i2t_optim_epsilon=1e-6)
    # dtype f32 on both sides: the trainers otherwise round the features
    # to bf16 (both defaults are "bfloat16")
    jt = JT(Config(**kw, dtype="float32", checkpoint_path=str(tmp_path)))
    pt = Trainer(TConfig(**kw, dtype="float32"), device="cpu")
    pt.i2t_model.load_state_dict(bridge.params_from_jax(jt.i2t_params))
    batch = _batch()
    cells0, att0 = lk.launches, aak.launches
    for _ in range(2):
        jm = jt.train(batch)
        tm = pt.train(batch)
        for key in ("total_loss", "i2t_loss"):
            np.testing.assert_allclose(tm[key], jm[key], rtol=TOL, atol=TOL)
    assert (lk.launches, aak.launches) == (cells0, att0)   # CPU: plain
    # two attentions a step over T + 1 inputs, two training steps
    assert len(calls) == (2 * (T + 1) * 2 if train_kernel else 0)
    got = bridge.params_to_numpy(pt.i2t_model)
    flat_j = jax.tree_util.tree_leaves_with_path(jt.i2t_params)
    assert len(flat_j) == len(list(pt.i2t_model.parameters()))
    for path, want in flat_j:
        node = got
        for p in path:
            node = node[getattr(p, "key", getattr(p, "idx", None))]
        np.testing.assert_allclose(node, np.asarray(want), rtol=TOL, atol=TOL,
                                   err_msg=jax.tree_util.keystr(path))
    mine = bridge.opt_state_from_optax(jt.optim.i2t_state)
    assert mine[1]["count"] == pt.optim.i2t_state[1]["count"] == 2
    for name in ("mu", "nu"):
        for k, t in pt.optim.i2t_state[1][name].items():
            np.testing.assert_allclose(t.numpy(), mine[1][name][k].numpy(),
                                       rtol=1e-4, atol=1e-9, err_msg=k)


def test_every_parameter_gets_a_gradient():
    """The LSTM cells pass the gradient on: every parameter upstream of an
    LSTM output moves in one step (the alpha_net biases excepted: their
    gradient is zero in exact arithmetic)."""
    tr = Trainer(TConfig(**dict(CFG, drop_prob_lm=0.0, i2t_optim="sgd",
                                i2t_learning_rate=1.0)), device="cpu")
    before = {k: v.detach().clone()
              for k, v in tr.i2t_model.state_dict().items()}
    tr.train(_batch())
    still = [k for k, v in tr.i2t_model.state_dict().items()
             if torch.equal(v, before[k]) and "alpha_net.b" not in k]
    assert not still


def test_dropout_steps_repeat_and_learn():
    runs = []
    for _ in range(2):
        tr = Trainer(TConfig(**dict(CFG, drop_prob_lm=0.5,
                                    i2t_learning_rate=1e-2)), device="cpu")
        batch = _batch(1)
        runs.append([tr.train(batch)["total_loss"] for _ in range(5)])
    assert all(np.isfinite(runs[0]))
    assert runs[0] == runs[1]
    assert runs[0][-1] < runs[0][0]


def test_scheduled_sampling_trains():
    tr = Trainer(TConfig(**dict(CFG, drop_prob_lm=0.5,
                                scheduled_sampling_start=0)), device="cpu")
    tr.epoch = 10                     # ss_prob 0.1 on the default schedule
    out = [tr.train(_batch(2)) for _ in range(3)]
    assert out[0]["ss_prob"] == pytest.approx(0.1)
    assert all(np.isfinite(o["total_loss"]) for o in out)


def test_plain_attention_is_checkpointed():
    """The plain single-query attention keeps no [B, N, A] tensor of its
    own for the backward (its tanh is recomputed in the backward, as under
    the JAX package's jax.checkpoint; the p_att input itself is kept), and
    its gradients equal those of the same computation without the
    recompute, which does keep one."""
    from unpaired_image_captioning_tpu_torch.models.base import init_module

    b, n, a, d, h = 3, 7, 10, 6, 5
    p = tatt.attention_init(h, a)
    init_module(p, torch.Generator().manual_seed(0))
    rs = np.random.RandomState(3)
    hq, p_att, emb = (torch.from_numpy(rs.randn(*s).astype(np.float32))
                      for s in ((b, h), (b, n, a), (b, n, d)))
    masks = torch.ones((b, n))
    masks[1, 5:] = 0.0
    got = {}
    for route in ("checkpointed", "plain"):
        ins = [t.clone().requires_grad_() for t in (hq, p_att, emb)]
        p_ptr = ins[1].data_ptr()
        shapes = []

        def pack(t):
            if tuple(t.shape) == (b, n, a) and t.data_ptr() != p_ptr:
                shapes.append(tuple(t.shape))
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            if route == "checkpointed":
                out = tatt.attention_apply(p, ins[0], ins[2], ins[1], masks,
                                           training=True)
            else:
                att_h = ins[0] @ p["h2att"].w + p["h2att"].b
                out = tatt._attend(p["alpha_net"].w, p["alpha_net"].b,
                                   ins[1], att_h, masks, ins[2])
        weights = [p["h2att"].w, p["alpha_net"].w, p["alpha_net"].b]
        grads = torch.autograd.grad((out * out).sum(), ins + weights)
        got[route] = (out.detach(), grads, bool(shapes))
    (out_c, g_c, kept_c), (out_p, g_p, kept_p) = (got["checkpointed"],
                                                  got["plain"])
    assert not kept_c and kept_p
    torch.testing.assert_close(out_c, out_p, rtol=0, atol=0)
    for gc, gp in zip(g_c, g_p):
        torch.testing.assert_close(gc, gp, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("masks", ["none", "all_masked_row"])
def test_recomputed_attention_backward_is_autograds(masks):
    """The hand-written backward of the recomputing attention gives the
    gradients autograd gives for the direct call, to the bit, with no mask
    and with a row whose mask is all zeros (the clamped denominator)."""
    from unpaired_image_captioning_tpu_torch.models.base import init_module

    b, n, a, d, h = 4, 9, 12, 8, 6
    p = tatt.attention_init(h, a)
    init_module(p, torch.Generator().manual_seed(1))
    rs = np.random.RandomState(5)
    hq, p_att, emb = (torch.from_numpy(rs.randn(*s).astype(np.float32))
                      for s in ((b, h), (b, n, a), (b, n, d)))
    mask = None
    if masks == "all_masked_row":
        mask = torch.ones((b, n))
        mask[0, 4:] = 0.0
        mask[2] = 0.0
    got = []
    for fn in (tatt._RecomputedAttend.apply, tatt._attend):
        ins = [t.clone().requires_grad_() for t in (hq, p_att, emb)]
        att_h = ins[0] @ p["h2att"].w + p["h2att"].b
        out = fn(p["alpha_net"].w, p["alpha_net"].b, ins[1], att_h, mask,
                 ins[2])
        weights = [p["h2att"].w, p["alpha_net"].w, p["alpha_net"].b]
        got.append((out.detach(), torch.autograd.grad(
            (out * out).sum(), ins + weights)))
    (out_r, g_r), (out_d, g_d) = got
    torch.testing.assert_close(out_r, out_d, rtol=0, atol=0)
    for gr, gd in zip(g_r, g_d):
        torch.testing.assert_close(gr, gd, rtol=0, atol=0)
