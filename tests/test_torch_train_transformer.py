"""The port's XE training step of the transformer captioner
(`train/trainer.py`) against the JAX `Trainer` at tiny widths (2 layers,
d 32, 4 heads, V 20, 6 att slots, seq_length 5, batch 3), Adam with the
global-norm clip: with every dropout at 0, on each of the port's three
training routes (per sublayer, whole encoder layers, whole encoder and
decoder layers), the losses of steps 1 and 2 and the parameters and Adam
moments after step 2 agree within 1e-5. With
dropout on, the port's loss is finite, repeats exactly from the same seed
and falls over 5 steps on one batch.

The parity run uses Adam's eps = 1e-6: the attention key biases have an
analytically zero gradient (a softmax row is shift-invariant), so each
framework feeds Adam its own rounding noise there (about 1e-9), and at
eps = 1e-8 Adam scales that noise up to updates of order lr.
"""

import numpy as np
import pytest
import torch

from unpaired_image_captioning_tpu_torch import bridge
from unpaired_image_captioning_tpu_torch.config import Config as TConfig
from unpaired_image_captioning_tpu_torch.kernels import layer_train as ltk
from unpaired_image_captioning_tpu_torch.kernels import ln_train as lnk
from unpaired_image_captioning_tpu_torch.kernels import mha_train as mhk
from unpaired_image_captioning_tpu_torch.models import transformer as ttr
from unpaired_image_captioning_tpu_torch.train.trainer import Trainer

B, N, T, V, L = 3, 6, 5, 20, 2
TOL = 1e-5
CFG = dict(caption_model="transformer", vocab_size=V, input_encoding_size=32,
           rnn_size=32, num_layers=L, num_heads=4, fc_feat_size=16,
           att_feat_size=16, att_hid_size=32, seq_length=T, batch_size=B,
           seq_per_img=1, i2t_train_flag=True, i2t_max_grad_norm=5.0,
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


# the port's three training routes: (TRAIN_LAYER_KERNEL,
# TRAIN_DEC_LAYER_KERNEL); the JAX Trainer runs its sublayer route on the CPU
ROUTES = {"sublayer": (False, False), "enc_layer": (True, False),
          "enc_dec_layer": (True, True)}


@pytest.mark.parametrize("route", list(ROUTES))
def test_xe_steps_match_jax_trainer(tmp_path, monkeypatch, route):
    from unpaired_image_captioning_tpu.config import Config
    from unpaired_image_captioning_tpu.models import transformer as jtr
    from unpaired_image_captioning_tpu.train.trainer import Trainer as JT

    monkeypatch.setattr(jtr, "DROPOUT", 0.0)
    monkeypatch.setattr(ttr, "DROPOUT", 0.0)
    enc_layer, dec_layer = ROUTES[route]
    monkeypatch.setattr(ttr, "TRAIN_LAYER_KERNEL", enc_layer)
    monkeypatch.setattr(ttr, "TRAIN_DEC_LAYER_KERNEL", dec_layer)
    calls = {"enc": 0, "dec": 0}
    for key, name in (("enc", "enc_layer_fwd"), ("dec", "dec_layer_fwd")):
        def spy(*a, _fn=getattr(ltk, name), _key=key, **kw):
            calls[_key] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(ltk, name, spy)
    kw = dict(CFG, drop_prob_lm=0.0, i2t_optim_epsilon=1e-6)
    # dtype f32: the JAX trainer otherwise rounds the features to bf16
    jt = JT(Config(**kw, dtype="float32", checkpoint_path=str(tmp_path)))
    pt = Trainer(TConfig(**kw), device="cpu")
    pt.i2t_model.load_state_dict(bridge.params_from_jax(jt.i2t_params))
    batch = _batch()
    mha0, ln0 = mhk.bwd_launches, lnk.bwd_launches
    for _ in range(2):
        jm = jt.train(batch)
        tm = pt.train(batch)
        np.testing.assert_allclose(tm["total_loss"], jm["total_loss"],
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(tm["i2t_loss"], jm["i2t_loss"], rtol=TOL,
                                   atol=TOL)
    assert (mhk.bwd_launches, lnk.bwd_launches) == (mha0, ln0)  # CPU: plain
    assert calls == {"enc": 2 * L * enc_layer, "dec": 2 * L * dec_layer}
    got = bridge.params_to_numpy(pt.i2t_model)
    import jax

    flat_j = jax.tree_util.tree_leaves_with_path(jt.i2t_params)
    assert len(flat_j) == len(list(pt.i2t_model.parameters()))
    for path, want in flat_j:
        node = got
        for p in path:
            node = node[getattr(p, "key", getattr(p, "idx", None))]
        np.testing.assert_allclose(node, np.asarray(want), rtol=TOL, atol=TOL,
                                   err_msg=jax.tree_util.keystr(path))
    # the Adam moments map to optax's and back
    adam = jt.optim.i2t_state[1]
    mine = bridge.opt_state_from_optax(jt.optim.i2t_state)
    assert mine[1]["count"] == int(adam.count) == pt.optim.i2t_state[1][
        "count"] == 2
    for name in ("mu", "nu"):
        for k, t in pt.optim.i2t_state[1][name].items():
            np.testing.assert_allclose(t.numpy(), mine[1][name][k].numpy(),
                                       rtol=1e-4, atol=1e-9, err_msg=k)
    back = bridge.opt_state_to_optax(pt.optim.i2t_state, jt.optim.i2t_state)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(jt.optim.i2t_state))


def test_dropout_steps_repeat_and_learn():
    cfg = TConfig(**CFG)
    runs = []
    for _ in range(2):
        tr = Trainer(cfg, device="cpu")
        batch = _batch(1)
        runs.append([tr.train(batch)["total_loss"] for _ in range(5)])
    assert all(np.isfinite(runs[0]))
    assert runs[0] == runs[1]
    assert runs[0][-1] < runs[0][0]


def test_unported_branches_raise():
    tr = Trainer(TConfig(**CFG), device="cpu")
    with pytest.raises(NotImplementedError, match="A8"):
        tr.train(_batch(), sc_flag=True)
    for fn in (tr.save, tr.load, tr.eval):
        with pytest.raises(NotImplementedError, match="A9"):
            fn()
    # NMT training is ported; its pretrained word vectors (read from
    # files) are not
    with pytest.raises(NotImplementedError, match="A9"):
        Trainer(TConfig(**CFG, nmt_src_vocab_size=9, nmt_tgt_vocab_size=9,
                        nmt_train_flag=True, pre_word_vecs_enc="emb.npy"),
                device="cpu")


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(TConfig(**CFG))
