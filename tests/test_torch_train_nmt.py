"""The port's NMT training against the JAX package at tiny widths (source
vocabulary 31, target 29, batch 3, sources of up to 6 tokens, targets of
7 with BOS ... EOS and PAD):

- the criteria (`losses/criterion.py`: `nmt_loss` with its statistics,
  label smoothing, KLD, Weight_Trans) against JAX `losses/criterion.py`,
  within 1e-6;
- the BiLSTM `NMTModel.forward` (outputs and attentions) and `gold_scores`
  against JAX, within 1e-5;
- `Trainer.train` with `nmt_train_flag` against the JAX `Trainer` over two
  steps, for the BiLSTM NMT alone (2 layers), with label smoothing 0.1 and
  `truncated_decoder` 3, jointly with the denseatt captioner under
  Weight_Trans, Weight_Trans_y and a KLD teacher, and for the transformer
  NMT (on the port's default training route): every metric, the
  parameters and the Adam moments within 1e-5 relative, with every dropout
  at 0 and Adam's eps at 1e-6 (as the captioners' parity tests: gradients
  that are zero in exact arithmetic carry each framework's rounding noise);
- one SGD step moves every NMT parameter.
"""

import numpy as np
import pytest
import torch

from unpaired_image_captioning_tpu_torch import bridge
from unpaired_image_captioning_tpu_torch.config import Config as TConfig
from unpaired_image_captioning_tpu_torch.kernels import layer_train as ltk
from unpaired_image_captioning_tpu_torch.losses import criterion as tcrit
from unpaired_image_captioning_tpu_torch.models import transformer as ttr
from unpaired_image_captioning_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)
SRC_V, TGT_V, B, S, T = 31, 29, 3, 6, 7
PAD, BOS, EOS = 0, 2, 3
TOL = 1e-5
NMT = dict(nmt_src_vocab_size=SRC_V, nmt_tgt_vocab_size=TGT_V,
           word_vec_size=24, rnn_size=24, layers=1, brnn=True, dropout=0.0,
           nmt_train_flag=True, nmt_optim="adam", nmt_learning_rate=1e-3,
           nmt_optim_epsilon=1e-6, nmt_max_grad_norm=5.0, seed=7)
# the denseatt captioner of the joint step: its embedding is as wide as the
# NMT's (Weight_Trans compares the two tables row by row)
CAP = dict(caption_model="denseatt", vocab_size=20, input_encoding_size=24,
           num_layers=1, fc_feat_size=16, att_feat_size=16, att_hid_size=24,
           seq_length=5, batch_size=B, seq_per_img=1, i2t_train_flag=True,
           i2t_max_grad_norm=5.0, i2t_learning_rate=5e-4, drop_prob_lm=0.0,
           i2t_optim_epsilon=1e-6)


def _nmt_batch(seed=0) -> dict:
    rs = np.random.RandomState(seed)
    lengths = np.array([S, 4, 1], np.int32)
    src = rs.randint(4, SRC_V, (B, S)).astype(np.int32)
    src[np.arange(S)[None, :] >= lengths[:, None]] = PAD
    tgt = np.zeros((B, T), np.int32)
    for i, n in enumerate((T - 2, 3, 1)):
        tgt[i, 0] = BOS
        tgt[i, 1:1 + n] = rs.randint(4, TGT_V, n)
        tgt[i, 1 + n] = EOS
    return {"src": src, "tgt": tgt, "lengths": lengths}


def _cap_batch(seed=0) -> dict:
    rs = np.random.RandomState(seed)
    t, v = CAP["seq_length"], CAP["vocab_size"]
    labels = np.zeros((B, t + 2), np.int64)
    masks = np.zeros((B, t + 2), np.float32)
    for i, n in enumerate((t, 3, 1)):
        labels[i, 1:1 + n] = rs.randint(1, v + 1, n)
        masks[i, :n + 2] = 1.0
    att_masks = np.ones((B, 6), np.float32)
    att_masks[1, 4:] = 0.0
    return {"fc_feats": rs.randn(B, 16).astype(np.float32),
            "att_feats": rs.randn(B, 6, 16).astype(np.float32),
            "att_masks": att_masks, "labels": labels, "masks": masks}


# ---------------------------------------------------------------------------
# criteria
# ---------------------------------------------------------------------------

def test_criteria_match_jax():
    import jax.numpy as jnp

    from unpaired_image_captioning_tpu.losses import criterion as jcrit

    rs = np.random.RandomState(1)
    logits = rs.randn(B, T - 1, TGT_V).astype(np.float32) * 3
    logits[0, 0, 5] = logits[0, 0, 7] = 40.0      # a tie: the first argmax
    tgt = _nmt_batch()["tgt"][:, 1:]
    tgt[0, 0] = 7
    for ls in (0.0, 0.1):
        jl, js = jcrit.nmt_loss(jnp.asarray(logits), jnp.asarray(tgt),
                                label_smoothing=ls)
        tl, ts = tcrit.nmt_loss(torch.from_numpy(logits),
                                torch.from_numpy(tgt), label_smoothing=ls)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
        for name in ("ppl", "accuracy"):
            np.testing.assert_allclose(float(getattr(ts, name)()),
                                       float(getattr(js, name)()), rtol=1e-6)
        np.testing.assert_allclose(float(ts.n_words), float(js.n_words))
        np.testing.assert_allclose(float(ts.n_correct), float(js.n_correct))
        both = ts + ts
        assert float(both.n_words) == 2 * float(ts.n_words)
        np.testing.assert_allclose(float(both.ppl()), float(ts.ppl()),
                                   rtol=1e-6)
    # ppl clamps its exponent at 100 (beyond the f32 range: inf in both);
    # n_words 0 counts as 1
    for loss, words in ((1e4, 2.0), (60.0, 0.0)):
        big = tcrit.NMTStats(torch.tensor(loss), torch.tensor(words),
                             torch.tensor(0.0))
        jbig = jcrit.NMTStats(jnp.float32(loss), jnp.float32(words),
                              jnp.float32(0.0))
        np.testing.assert_allclose(float(big.ppl()), float(jbig.ppl()),
                                   rtol=1e-6)
        assert float(big.accuracy()) == float(jbig.accuracy()) == 0.0
    lp = torch.log_softmax(torch.from_numpy(logits.reshape(-1, TGT_V)), -1)
    flat = torch.from_numpy(tgt.reshape(-1))
    jlp = jnp.asarray(lp.numpy())
    np.testing.assert_allclose(
        tcrit.label_smoothing_loss(lp, flat, smoothing=0.2).numpy(),
        np.asarray(jcrit.label_smoothing_loss(jlp, jnp.asarray(tgt.reshape(
            -1)), smoothing=0.2, reduce=False)), rtol=1e-6, atol=1e-6)
    teacher = torch.softmax(torch.from_numpy(rs.randn(B * (T - 1), TGT_V)
                                             .astype(np.float32)), -1)
    teacher[0, :4] = 0.0                          # the 1e-20 clamp
    np.testing.assert_allclose(
        float(tcrit.kld_loss(lp, teacher)),
        float(jcrit.kld_loss(jlp, jnp.asarray(teacher.numpy()))), rtol=1e-6)
    a = rs.randn(12, 5).astype(np.float32)
    b = rs.randn(9, 5).astype(np.float32)
    ra, rb = np.array([1, 4, 11, 4]), np.array([0, 8, 2, 3])
    np.testing.assert_allclose(
        float(tcrit.weight_trans_loss(torch.from_numpy(a), torch.from_numpy(b),
                                      torch.from_numpy(ra),
                                      torch.from_numpy(rb))),
        float(jcrit.weight_trans_loss(jnp.asarray(a), jnp.asarray(b),
                                      jnp.asarray(ra), jnp.asarray(rb))),
        rtol=1e-6)


# ---------------------------------------------------------------------------
# NMTModel.forward and gold_scores
# ---------------------------------------------------------------------------

def test_forward_and_gold_scores_match_jax():
    import jax
    import jax.numpy as jnp

    from unpaired_image_captioning_tpu.models.nmt import NMTModel as JNMT
    from unpaired_image_captioning_tpu_torch.models.nmt import NMTModel

    kw = dict(src_vocab_size=SRC_V, tgt_vocab_size=TGT_V, word_vec_size=16,
              rnn_size=24, layers=2, dropout=0.3)
    jm = JNMT(**kw)
    jp = jm.init_params(jax.random.PRNGKey(2))
    tm = NMTModel(**kw, device="cpu")
    tm.load_state_dict(bridge.params_from_jax(jp))
    nb = _nmt_batch(3)
    jin = [jnp.asarray(nb[k]) for k in ("src", "lengths", "tgt")]
    tin = [torch.from_numpy(nb[k]).long() for k in ("src", "lengths", "tgt")]
    jo, ja = jm.forward(jp, *jin)
    with torch.no_grad():
        to, ta = tm.forward(*tin)
        tg = tm.gold_scores(*tin)
    assert to.shape == (B, T - 1, 24) and ta.shape == (B, T - 1, S)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=TOL)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=TOL)
    np.testing.assert_allclose(tg.numpy(),
                               np.asarray(jm.gold_scores(jp, *jin)),
                               rtol=TOL, atol=TOL)
    assert tm.src_embedding() is tm.encoder.embeddings.word_lut
    assert tm.tgt_embedding() is tm.decoder.embeddings.word_lut


# ---------------------------------------------------------------------------
# Trainer.train with nmt_train_flag against the JAX Trainer
# ---------------------------------------------------------------------------

CASES = {
    "bilstm": dict(layers=2),
    "bilstm_smoothing_truncated": dict(label_smoothing=0.1,
                                       truncated_decoder=3),
    "joint_denseatt": dict(CAP, nmt_kld_train_flag=True),
    "transformer": dict(nmt_model_type="transformer", word_vec_size=32,
                        rnn_size=32, layers=2, num_heads=4),
}


def _leaves_close(tree_j, got, what: str) -> None:
    import jax

    flat = jax.tree_util.tree_leaves_with_path(tree_j)
    for path, want in flat:
        node = got
        for p in path:
            node = node[getattr(p, "key", getattr(p, "idx", None))]
        np.testing.assert_allclose(node, np.asarray(want), rtol=TOL, atol=TOL,
                                   err_msg=f"{what}{jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("case", list(CASES))
def test_nmt_steps_match_jax_trainer(tmp_path, monkeypatch, case):
    import jax

    from unpaired_image_captioning_tpu.config import Config
    from unpaired_image_captioning_tpu.models import transformer as jtr
    from unpaired_image_captioning_tpu.train.trainer import Trainer as JT

    monkeypatch.setattr(jtr, "DROPOUT", 0.0)
    monkeypatch.setattr(ttr, "DROPOUT", 0.0)
    calls = [0]

    def spy(*a, _fn=ltk.enc_layer_fwd, **kw):
        calls[0] += 1
        return _fn(*a, **kw)

    monkeypatch.setattr(ltk, "enc_layer_fwd", spy)
    kw = dict(NMT, **CASES[case])
    joint = case == "joint_denseatt"
    extra_j, extra_t = {}, {}
    if joint:
        # the Weight_Trans rows, a frozen English table for Weight_Trans_y
        # and a teacher with other weights
        rs = np.random.RandomState(9)
        cap_rows, src_rows = np.array([1, 3, 4, 9, 20]), np.array(
            [5, 3, 30, 8, 12])
        table = rs.randn(15, 24).astype(np.float32) * 0.1
        table_rows, tgt_rows = np.array([0, 4, 14]), np.array([4, 28, 7])
        cfg_t = Config(**kw, dtype="float32", checkpoint_path=str(tmp_path))
        from unpaired_image_captioning_tpu.models.nmt_transformer import (
            make_nmt_model)
        teacher = make_nmt_model(cfg_t).init_params(jax.random.PRNGKey(11))
        extra_j = dict(joint_vocab=(cap_rows, src_rows),
                       joint_vocab_y=(table, table_rows, tgt_rows),
                       nmt_teacher_params=teacher)
        extra_t = dict(joint_vocab=(cap_rows, src_rows),
                       joint_vocab_y=(table, table_rows, tgt_rows),
                       nmt_teacher=bridge.params_from_jax(teacher))
    # dtype f32 on both sides: the trainers otherwise round the features
    # to bf16 (both defaults are "bfloat16")
    jt = JT(Config(**kw, dtype="float32", checkpoint_path=str(tmp_path)),
            **extra_j)
    pt = Trainer(TConfig(**kw, dtype="float32"), device="cpu", **extra_t)
    pt.nmt_model.load_state_dict(bridge.params_from_jax(jt.nmt_params))
    if joint:
        pt.i2t_model.load_state_dict(bridge.params_from_jax(jt.i2t_params))
    batch = {"nmt": _nmt_batch()}
    if joint:
        batch.update(_cap_batch())
    for _ in range(2):
        jm = jt.train(batch)
        tm = pt.train(batch)
        assert set(tm) == set(jm)
        for key, want in jm.items():
            np.testing.assert_allclose(tm[key], want, rtol=TOL, atol=TOL,
                                       err_msg=key)
    want_keys = {"nmt_loss", "nmt_ppl", "nmt_acc", "nmt_words", "total_loss"}
    if joint:
        want_keys |= {"i2t_loss", "wemb_loss", "wemb_y_loss", "nmt_kld"}
    assert want_keys <= set(tm)
    # the transformer's encoder layers take the whole-layer route
    transformer = case == "transformer"
    assert calls[0] == (2 * 2 if transformer else 0)
    models = [("nmt", pt.nmt_model, jt.nmt_params, jt.optim.nmt_state,
               pt.optim.nmt_state)]
    if joint:
        models.append(("i2t", pt.i2t_model, jt.i2t_params,
                       jt.optim.i2t_state, pt.optim.i2t_state))
    for name, model, params_j, state_j, state_t in models:
        assert len(jax.tree_util.tree_leaves(params_j)) == len(
            list(model.parameters()))
        _leaves_close(params_j, bridge.params_to_numpy(model), name)
        mine = bridge.opt_state_from_optax(state_j)
        assert mine[1]["count"] == state_t[1]["count"] == 2
        for moment in ("mu", "nu"):
            for k, t in state_t[1][moment].items():
                np.testing.assert_allclose(
                    t.numpy(), mine[1][moment][k].numpy(), rtol=1e-4,
                    atol=1e-9, err_msg=f"{name} {moment} {k}")


@pytest.mark.parametrize("case", ["bilstm", "transformer"])
def test_every_nmt_parameter_gets_a_gradient(case):
    """One SGD step at learning rate 1 moves every NMT parameter (the
    attention key biases of the transformer excepted: their gradient is
    zero in exact arithmetic)."""
    kw = dict(NMT, **CASES[case], nmt_optim="sgd", nmt_learning_rate=1.0)
    tr = Trainer(TConfig(**kw, dtype="float32"), device="cpu")
    before = {k: v.detach().clone()
              for k, v in tr.nmt_model.state_dict().items()}
    out = tr.train({"nmt": _nmt_batch()})
    assert np.isfinite(out["nmt_loss"]) and out["nmt_words"] == 12.0
    still = [k for k, v in tr.nmt_model.state_dict().items()
             if torch.equal(v, before[k]) and not k.endswith("k.b")]
    assert not still


def test_truncated_decoder_cuts_the_gradient():
    """truncated_decoder n detaches the decoder state before each step idx
    > 0 with idx % n == 0: at n 3 over 6 steps the gradient changes, at
    n 6 (no boundary inside the sequence) it is the untruncated one."""
    from unpaired_image_captioning_tpu_torch.models.nmt import NMTModel

    kw = dict(src_vocab_size=SRC_V, tgt_vocab_size=TGT_V, word_vec_size=16,
              rnn_size=24, layers=1, dropout=0.0)
    nb = _nmt_batch(5)
    src, lengths, tgt = (torch.from_numpy(nb[k]).long()
                         for k in ("src", "lengths", "tgt"))
    grads = {}
    for trunc in (0, 3, T - 1):
        m = NMTModel(**kw, truncated_decoder=trunc, device="cpu").init_params(
            torch.Generator().manual_seed(0))
        outs, _ = m.forward(src, lengths, tgt, training=True)
        lp = torch.log_softmax(m.generator_logits(outs), -1)
        (-torch.gather(lp, -1, tgt[:, 1:, None]).sum()).backward()
        grads[trunc] = m.decoder.rnn[0].w.grad.clone()
    assert torch.equal(grads[T - 1], grads[0])
    assert (grads[3] - grads[0]).abs().max() > 1e-4
