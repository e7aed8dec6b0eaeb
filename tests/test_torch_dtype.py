"""PyTorch port, the compute dtype (ROADMAP A15) against the JAX package on
the CPU, at tiny widths (H = E 24, 6 att slots, one image padded), dropout
off:

- the config: the port's fields are JAX's plus `device`, `--dtype` parses;
- (d) the feature rounding of the loader (`feat_dtype="bfloat16"`), the
  trainer's upload and the feature workers' shared memory, bit for bit
  against `ml_dtypes.bfloat16`: ties to even, +-inf, NaN, subnormals,
  values past the bf16 maximum;
- (a) JAX's default config (`dtype="bfloat16"`): the JAX `Trainer` on the
  CPU rounds the features on the host and computes with f32 weights, so
  the models carry bf16 features and a bf16 LSTM state; the port's
  `Trainer` with the same config does the same. The joint denseatt +
  BiLSTM NMT steps (the metrics of two SGD steps and the parameters after
  them) at the f32 tolerance TOL, as are the other trainer parity tests; one
  transformer XE step at BF16_TOL: both keep the bf16 features bf16
  through the encoder (`linear` returns its input's type), so its
  activations are bf16 values;
- (b) the cast route, what `Trainer._cast_compute` gives on a TPU: the
  JAX trees and features cast to bf16 by the test around
  `Trainer._loss_terms` (its `_cast_compute` is the identity on the CPU),
  against the port's `Trainer` with its cast route forced on the CPU
  (`bf16_params`): the joint XE loss and its gradients on the f32
  masters, an SCST loss on given samples, one XE loss and its gradients
  for every LSTM family; at JAX's bf16 tolerance BF16_TOL
  (`tests/test_ln_train.py:61-71`);
- (c) decoding bf16 features with f32 weights (the card's serving and
  eval): the LSTM pivot (denseatt beam 3 -> BiLSTM NMT beam 3) and the
  transformer captioner's beam, tokens identical; a flip would be
  reported with its logprob margin;
- (e) the plain versions of B1, B9a-c and B10 in each dtype mixture
  against the JAX reference functions (`lstm_step_ref`,
  `_reference_attention*`, the Pallas decode step in interpret mode, the
  B10 scan of `tests/test_lstm_block.py:29-40`) at BF16_TOL.
"""

import numpy as np
import pytest
import torch

from unpaired_image_captioning_tpu_torch import bridge
from unpaired_image_captioning_tpu_torch import models as tmodels
from unpaired_image_captioning_tpu_torch.config import Config as TConfig
from unpaired_image_captioning_tpu_torch.kernels import (
    additive_attention as aak)
from unpaired_image_captioning_tpu_torch.kernels import lstm_block as lb
from unpaired_image_captioning_tpu_torch.kernels import lstm_cell as lk
from unpaired_image_captioning_tpu_torch.losses import criterion as tcrit
from unpaired_image_captioning_tpu_torch.models.base import Features
from unpaired_image_captioning_tpu_torch.ops import attention as tatt
from unpaired_image_captioning_tpu_torch.ops import lstm_block as tlo
from unpaired_image_captioning_tpu_torch.train.trainer import (Trainer,
                                                                bf16_params)

torch.set_num_threads(1)
TOL = 1e-5        # f32 parity: sums in another order
BF16_TOL = 1e-2   # rtol = atol: JAX's bf16 tolerance
B, N, V, T = 3, 6, 20, 5
SRC_V, TGT_V, S, TT = 31, 29, 6, 7
PAD, BOS, EOS = 0, 2, 3
NMT = dict(nmt_src_vocab_size=SRC_V, nmt_tgt_vocab_size=TGT_V,
           word_vec_size=24, rnn_size=24, layers=1, brnn=True, dropout=0.0,
           nmt_train_flag=True, nmt_optim="adam", nmt_learning_rate=1e-3,
           nmt_optim_epsilon=1e-6, nmt_max_grad_norm=5.0, seed=7)
CAP = dict(caption_model="denseatt", vocab_size=V, input_encoding_size=24,
           num_layers=1, fc_feat_size=16, att_feat_size=16, att_hid_size=24,
           seq_length=T, batch_size=B, seq_per_img=1, i2t_train_flag=True,
           i2t_max_grad_norm=5.0, i2t_learning_rate=5e-4, drop_prob_lm=0.0,
           i2t_optim_epsilon=1e-6)
JOINT = dict(NMT, **CAP)
FAMILIES = ["fc", "topdown", "att2in", "att2in2", "att2all2", "adaatt",
            "adaattmo", "show_tell", "all_img", "show_attend_tell",
            "stackcap", "stackatt", "denseatt"]
FAM = dict(vocab_size=V, rnn_size=24, input_encoding_size=24,
           att_hid_size=16, fc_feat_size=16, att_feat_size=16,
           attri_feat_size=7, seq_length=T, num_layers=2, drop_prob_lm=0.0)


def _bf16_np(a):
    import ml_dtypes

    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16)


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


def _nmt_batch(seed=0) -> dict:
    rs = np.random.RandomState(seed)
    lengths = np.array([S, 4, 1], np.int32)
    src = rs.randint(4, SRC_V, (B, S)).astype(np.int32)
    src[np.arange(S)[None, :] >= lengths[:, None]] = PAD
    tgt = np.zeros((B, TT), np.int32)
    for i, n in enumerate((TT - 2, 3, 1)):
        tgt[i, 0] = BOS
        tgt[i, 1:1 + n] = rs.randint(4, TGT_V, n)
        tgt[i, 1 + n] = EOS
    return {"src": src, "tgt": tgt, "lengths": lengths}


def _cap_batch(seed=0, fc=16, att=16) -> dict:
    rs = np.random.RandomState(seed)
    labels = np.zeros((B, T + 2), np.int64)
    masks = np.zeros((B, T + 2), np.float32)
    for i, n in enumerate((T, 3, 1)):
        labels[i, 1:1 + n] = rs.randint(1, V + 1, n)
        masks[i, :n + 2] = 1.0
    att_masks = np.ones((B, N), np.float32)
    att_masks[1, 4:] = 0.0
    return {"fc_feats": rs.randn(B, fc).astype(np.float32),
            "att_feats": rs.randn(B, N, att).astype(np.float32),
            "attri_feats": rs.rand(B, 7).astype(np.float32),
            "att_masks": att_masks, "labels": labels, "masks": masks}


def _joint_extras():
    """Weight_Trans rows and a frozen English table for Weight_Trans_y."""
    rs = np.random.RandomState(9)
    cap_rows, src_rows = np.array([1, 3, 4, 9, 20]), np.array(
        [5, 3, 30, 8, 12])
    table = rs.randn(15, 24).astype(np.float32) * 0.1
    table_rows, tgt_rows = np.array([0, 4, 14]), np.array([4, 28, 7])
    return dict(joint_vocab=(cap_rows, src_rows),
                joint_vocab_y=(table, table_rows, tgt_rows))


# ---------------------------------------------------------------------------
# the config
# ---------------------------------------------------------------------------

def test_config_fields_equal_jax():
    """Every field of the JAX Config, dtype and param_dtype included, plus
    the port's own `device`; the dtype defaults are equal ("bfloat16")."""
    import dataclasses

    from unpaired_image_captioning_tpu.config import Config as JConfig
    from unpaired_image_captioning_tpu_torch.config import parse_opt

    jf = {f.name for f in dataclasses.fields(JConfig)}
    tf = {f.name for f in dataclasses.fields(TConfig)}
    assert tf == jf | {"device"}
    assert TConfig().dtype == JConfig().dtype == "bfloat16"
    assert TConfig().param_dtype == JConfig().param_dtype == "float32"
    assert parse_opt(["--dtype", "bfloat16"]).dtype == "bfloat16"
    with pytest.raises(ValueError, match="bfloat16"):
        Trainer(TConfig(**CAP, dtype="float16"), device="cpu")


# ---------------------------------------------------------------------------
# (d) the rounding bits
# ---------------------------------------------------------------------------

def _special_values() -> np.ndarray:
    """Ties to even both ways, +-inf, NaN, subnormals of f32 and of bf16,
    the bf16 maximum and values past it, and random values."""
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -7)             # bf16's ulp at 1
    vals = [one + ulp / 2, one + 3 * ulp / 2, -(one + ulp / 2),
            one + ulp / 2 + np.float32(2.0 ** -23), np.inf, -np.inf, np.nan,
            -np.nan, np.array(0x7FA00000, np.uint32).view(np.float32),
            np.array(0xFF800001, np.uint32).view(np.float32), 0.0, -0.0, 1e-40, -3e-42, 1.1e-38, 9e-39,
            3.3895314e38, 3.3963e38, 3.40e38, -3.39e38,
            np.finfo(np.float32).max, np.finfo(np.float32).tiny]
    rs = np.random.RandomState(0)
    return np.concatenate([np.asarray(vals, np.float32),
                           rs.randn(200).astype(np.float32) * 100])


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int16).numpy().view(np.uint16)


@pytest.mark.parametrize("where", ["loader", "trainer"])
def test_rounding_bits_match_ml_dtypes(where):
    from unpaired_image_captioning_tpu_torch.data.dataloader import (
        to_bfloat16)

    x = _special_values()
    want = _bf16_np(x).view(np.uint16)
    if where == "loader":
        got = _bits(to_bfloat16(x))
    else:
        tr = Trainer(TConfig(**CAP, dtype="bfloat16"), device="cpu")
        batch = tr._batch({"fc_feats": x[None], "att_masks": x[None],
                           "labels": np.zeros((1, 2), np.int64)})
        got = _bits(batch["fc_feats"][0])
        # only the three feature keys are rounded; ids become int64
        assert batch["att_masks"].dtype == torch.float32
        assert batch["labels"].dtype == torch.int64
    np.testing.assert_array_equal(got, want)


def test_feature_workers_carry_bf16_bit_patterns(monkeypatch):
    """The bf16 features' trip through a worker's shared memory (16-bit
    patterns, half the f32 bytes) and the parent's view back."""
    import queue
    import threading

    from unpaired_image_captioning_tpu_torch.data import prefetch
    from unpaired_image_captioning_tpu_torch.data.dataloader import (
        to_bfloat16)

    x = _special_values().reshape(2, -1)
    feats = {"att_feats": to_bfloat16(x), "att_masks": np.ones(2, np.float32),
             "fc_feats": to_bfloat16(x[:, :3])}

    class Reader:
        def reopen(self):
            pass

        def gather(self, ixs):
            return feats

    class Loader:
        @staticmethod
        def replicate(f, rows=None):
            return {k: (v.clone() if isinstance(v, torch.Tensor)
                        else v.copy()) for k, v in f.items()}

    class Stale:
        value = 0

    monkeypatch.setattr(prefetch, "_SHM_MIN_BYTES", 64)
    tasks, results = queue.Queue(), queue.Queue()
    tasks.put((0, [0]))
    tasks.put(None)
    worker = threading.Thread(target=prefetch._feature_worker,
                              args=(Reader(), tasks, results, Stale()))
    worker.start()
    worker.join(30)
    _, out = results.get()
    assert out["att_feats"][0] == "shm" and out["fc_feats"][0] == "raw"
    pf = prefetch.ProcessPrefetcher.__new__(prefetch.ProcessPrefetcher)
    pf.loader = Loader()
    got = pf._materialize(out)
    for k in ("att_feats", "fc_feats"):
        assert got[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(got[k]), _bits(feats[k]))
    np.testing.assert_array_equal(got["att_masks"], feats["att_masks"])


# ---------------------------------------------------------------------------
# (a) JAX's default config on the CPU
# ---------------------------------------------------------------------------

def _leaves_close(tree_j, model, tol, what):
    import jax

    got = bridge.params_to_numpy(model)
    for path, want in jax.tree_util.tree_leaves_with_path(tree_j):
        node = got
        for p in path:
            node = node[getattr(p, "key", getattr(p, "idx", None))]
        _close(node, want, tol, what + jax.tree_util.keystr(path))


def test_default_config_joint_steps_match_jax(tmp_path):
    """Two joint XE steps (denseatt + BiLSTM NMT, Weight_Trans / _y) from
    JAX's default config: the same metrics and parameters. SGD, not Adam:
    the gradients of ops in bf16 are bf16-grained (a bias's sum over rows
    rounds to bf16), and Adam's per-element normalisation would move an
    element whose gradient is near 0 by up to lr on a 2^-8 difference; SGD
    moves it by lr x the difference, inside TOL."""
    from unpaired_image_captioning_tpu.config import Config
    from unpaired_image_captioning_tpu.train.trainer import Trainer as JT

    kw = dict(JOINT, i2t_optim="sgd", nmt_optim="sgd")
    jt = JT(Config(**kw, checkpoint_path=str(tmp_path)), **_joint_extras())
    assert jt.cfg.dtype == "bfloat16"
    pt = Trainer(TConfig(**kw, dtype="bfloat16"), device="cpu",
                 **_joint_extras())
    assert not pt.cast
    pt.nmt_model.load_state_dict(bridge.params_from_jax(jt.nmt_params))
    pt.i2t_model.load_state_dict(bridge.params_from_jax(jt.i2t_params))
    batch = dict(_cap_batch(), nmt=_nmt_batch())
    for _ in range(2):
        jm, tm = jt.train(batch), pt.train(batch)
        assert set(tm) == set(jm)
        for key, want in jm.items():
            _close(tm[key], want, TOL, key)
    for name, model, tree in (("i2t", pt.i2t_model, jt.i2t_params),
                              ("nmt", pt.nmt_model, jt.nmt_params)):
        _leaves_close(tree, model, TOL, name)


def test_default_config_transformer_step_matches_jax(tmp_path,
                                                    monkeypatch):
    """One transformer XE step from JAX's default config: bf16 features
    through f32 weights, so a bf16 encoder on both sides; BF16_TOL, the
    bf16 route's tolerance."""
    from unpaired_image_captioning_tpu.config import Config
    from unpaired_image_captioning_tpu.models import transformer as jtr
    from unpaired_image_captioning_tpu.train.trainer import Trainer as JT
    from unpaired_image_captioning_tpu_torch.models import transformer as ttr

    monkeypatch.setattr(jtr, "DROPOUT", 0.0)
    monkeypatch.setattr(ttr, "DROPOUT", 0.0)
    kw = dict(CAP, caption_model="transformer", input_encoding_size=32,
              rnn_size=32, num_layers=2, num_heads=4, att_hid_size=32)
    jt = JT(Config(**kw, checkpoint_path=str(tmp_path)))
    pt = Trainer(TConfig(**kw, dtype="bfloat16"), device="cpu")
    pt.i2t_model.load_state_dict(bridge.params_from_jax(jt.i2t_params))
    batch = _cap_batch()
    jm, tm = jt.train(batch), pt.train(batch)
    _close(tm["i2t_loss"], jm["i2t_loss"], BF16_TOL, "i2t_loss")
    _leaves_close(jt.i2t_params, pt.i2t_model, BF16_TOL, "i2t")


# ---------------------------------------------------------------------------
# (b) the cast route
# ---------------------------------------------------------------------------

def _cast(tree):
    """JAX's `_cast_compute`: every f32 leaf to bf16."""
    import jax
    import jax.numpy as jnp

    return jax.tree.map(lambda x: x.astype(jnp.bfloat16)
                        if x.dtype == jnp.float32 else x, tree)


def _jax_batch(batch: dict) -> dict:
    """The JAX trainer's upload with cfg.dtype bf16: features rounded."""
    import jax.numpy as jnp

    out = {k: jnp.asarray(_bf16_np(v) if k.endswith("_feats") else v)
           for k, v in batch.items() if k != "nmt"}
    if "nmt" in batch:
        out["nmt"] = {k: jnp.asarray(v) for k, v in batch["nmt"].items()}
    return out


def _port_cast_grads(pt, batch, sc_flag=False):
    """The port's cast route on the CPU: the step's forward and backward
    under `bf16_params`; returns (the metrics, {model: {name: grad}})."""
    pt.cast = True
    metrics = {}
    with pt._compute_params():
        total, _ = pt._losses(batch, sc_flag, pt.i2t_model is not None,
                              pt.nmt_model is not None, 0.0, metrics)
        total.backward()
    metrics["total_loss"] = total
    grads = {key: {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                   for n, p in model.named_parameters()}
             for key, model in pt._models() if model is not None}
    return metrics, grads


def _grads_close(got: dict, tree, what: str, tol=BF16_TOL):
    want = bridge.params_from_jax(tree)
    assert set(got) == set(want), what
    for name, g in got.items():
        assert g.dtype == torch.float32, name     # on the f32 master
        _close(g.numpy(), want[name].numpy(), tol, f"{what} {name}")


def test_cast_route_joint_xe_matches_jax(tmp_path):
    """The joint XE loss and its gradients on the f32 masters, the JAX
    trees cast to bf16 around `_loss_terms` (what a TPU computes)."""
    import jax
    import jax.numpy as jnp

    from unpaired_image_captioning_tpu.config import Config
    from unpaired_image_captioning_tpu.train.trainer import Trainer as JT

    jt = JT(Config(**JOINT, checkpoint_path=str(tmp_path)), **_joint_extras())
    pt = Trainer(TConfig(**JOINT, dtype="bfloat16"), device="cpu",
                 **_joint_extras())
    pt.nmt_model.load_state_dict(bridge.params_from_jax(jt.nmt_params))
    pt.i2t_model.load_state_dict(bridge.params_from_jax(jt.i2t_params))
    batch = dict(_cap_batch(), nmt=_nmt_batch())
    jb = _jax_batch(batch)

    def loss(ps):
        return jt._loss_terms(_cast(ps[0]), _cast(ps[1]), jb, jnp.float32(0.0),
                              jax.random.PRNGKey(0), rl=False,
                              ss_enabled=False)

    (_, jm), (gi, gn) = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        (jt.i2t_params, jt.nmt_params))
    tm, grads = _port_cast_grads(pt, batch)
    for key in ("total_loss", "i2t_loss", "nmt_loss", "wemb_loss",
                "wemb_y_loss", "nmt_acc"):
        _close(float(tm[key].detach()), float(jm[key]), BF16_TOL, key)
    _grads_close(grads["i2t"], gi, "i2t")
    _grads_close(grads["nmt"], gn, "nmt")


def test_cast_route_scst_loss_matches_jax(tmp_path, monkeypatch):
    """An SCST loss on given samples (both decodes patched to return them,
    as tests/test_torch_scst.py does) and its gradients, cast route."""
    import jax
    import jax.numpy as jnp

    from unpaired_image_captioning_tpu.config import Config
    from unpaired_image_captioning_tpu.ops import cider as jc
    from unpaired_image_captioning_tpu.train.trainer import Trainer as JT
    from unpaired_image_captioning_tpu_torch.ops import cider as tc
    from unpaired_image_captioning_tpu_torch.scripts.prepro_ngrams import (
        compute_df)

    rs = np.random.RandomState(3)
    rows = np.zeros((40, T + 2), np.int64)
    for i in range(len(rows)):
        n = rs.randint(2, T + 3)
        rows[i, :n] = rs.randint(1, V + 1, n)
    start = np.arange(10) * 4 + 1
    df, n_img = compute_df(rows, start, start + 3)
    batch = _cap_batch()
    batch.update(gts=rows[:B * 4].reshape(B, 4, -1),
                 gts_masks=np.ones((B, 4), np.float32))
    gen = rows[[0, 5, 9], 1:T + 1].copy()
    gen[gen == 0] = 1
    gen[0, 3:] = 0
    greedy = rs.randint(1, V + 1, (B, T))
    jt = JT(Config(**CAP, checkpoint_path=str(tmp_path)),
            df_table=jc.build_df_table(df, n_img))
    pt = Trainer(TConfig(**CAP, dtype="bfloat16"), device="cpu",
                 df_table=tc.build_df_table(df, n_img, device="cpu"))
    pt.i2t_model.load_state_dict(bridge.params_from_jax(jt.i2t_params))

    def pick(is_greedy):
        return greedy if is_greedy else gen

    monkeypatch.setattr(type(jt.i2t_model), "sample",
                        lambda self, params, feats, rng, *, greedy=True, **_:
                        (jnp.asarray(pick(greedy), jnp.int32), None))
    monkeypatch.setattr(pt.i2t_model, "sample",
                        lambda feats, *, greedy=True, **_: (
                            torch.from_numpy(pick(greedy)), None))
    jb = _jax_batch(batch)

    def loss(p):
        return jt._loss_terms(_cast(p), None, jb, jnp.float32(0.0),
                              jax.random.PRNGKey(0), rl=True)

    (_, jm), gi = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jt.i2t_params)
    tm, grads = _port_cast_grads(pt, batch, sc_flag=True)
    for key in ("i2t_loss", "avg_reward"):
        _close(float(tm[key].detach()), float(jm[key]), BF16_TOL, key)
    assert float(jm["i2t_loss"]) != 0.0
    _grads_close(grads["i2t"], gi, "i2t")


@pytest.mark.parametrize("family", FAMILIES)
def test_cast_route_family_xe_matches_jax(family):
    """One XE loss and its gradients of each LSTM family on cast trees and
    bf16 features (the cast route's forward, training=False)."""
    import jax
    import jax.numpy as jnp

    from unpaired_image_captioning_tpu import models as jmodels
    from unpaired_image_captioning_tpu.config import Config
    from unpaired_image_captioning_tpu.losses import criterion as jcrit
    from unpaired_image_captioning_tpu.models.base import Features as JF

    cfg = dict(FAM, caption_model=family)
    jm = jmodels.setup(Config(**cfg))
    jp = jm.init_params(jax.random.PRNGKey(FAMILIES.index(family)))
    tm = tmodels.setup(TConfig(**cfg), device="cpu")
    tm.load_state_dict(bridge.params_from_jax(jp))
    b = _cap_batch(seed=4)
    feats = {k: _bf16_np(b[k]) for k in ("fc_feats", "att_feats",
                                         "attri_feats")}
    jf = JF(fc_feats=jnp.asarray(feats["fc_feats"]),
            att_feats=jnp.asarray(feats["att_feats"]),
            attri_feats=jnp.asarray(feats["attri_feats"]),
            att_masks=jnp.asarray(b["att_masks"]))
    seq, masks = b["labels"], b["masks"]

    def loss(p):
        out = jm.forward(_cast(p), jf, jnp.asarray(seq, jnp.int32),
                         training=False)
        return jcrit.language_model_loss(out, jnp.asarray(seq[:, 1:]),
                                         jnp.asarray(masks[:, 1:]))

    lj, gj = jax.jit(jax.value_and_grad(loss))(jp)
    from unpaired_image_captioning_tpu_torch.data.dataloader import (
        to_bfloat16)

    tf = Features(fc_feats=to_bfloat16(b["fc_feats"]),
                  att_feats=to_bfloat16(b["att_feats"]),
                  attri_feats=to_bfloat16(b["attri_feats"]),
                  att_masks=torch.from_numpy(b["att_masks"]))
    with bf16_params(tm):
        out = tm.forward(tf, torch.from_numpy(seq), training=False)
        lt = tcrit.language_model_loss(out, torch.from_numpy(seq[:, 1:]),
                                       torch.from_numpy(masks[:, 1:]))
    lt.backward()
    _close(lt.item(), float(lj), BF16_TOL, f"{family} loss")
    _grads_close({n: (p.grad if p.grad is not None
                      else torch.zeros_like(p))
                  for n, p in tm.named_parameters()}, gj, family)


# ---------------------------------------------------------------------------
# (c) decoding bf16 features with f32 weights
# ---------------------------------------------------------------------------

def _decode_setup(caption_model):
    """A tiny captioner (and the BiLSTM NMT) on JAX's parameters, and bf16
    features of 4 images (image 2 padded)."""
    import jax
    import jax.numpy as jnp

    import __graft_entry__
    from unpaired_image_captioning_tpu.config import Config
    from unpaired_image_captioning_tpu.models.base import Features as JF
    from unpaired_image_captioning_tpu.models.nmt import NMTModel as JNMT
    from unpaired_image_captioning_tpu_torch.data.dataloader import (
        to_bfloat16)
    from unpaired_image_captioning_tpu_torch.models.nmt import NMTModel

    cfg = Config(**{**vars(__graft_entry__._tiny_cfg()),
                    "caption_model": caption_model, "num_layers": 2,
                    "num_heads": 4})
    from unpaired_image_captioning_tpu import models as jmodels

    jcap = jmodels.setup(cfg)
    jcp = jcap.init_params(jax.random.PRNGKey(0))
    tcap = tmodels.setup(cfg, device="cpu")
    tcap.load_state_dict(bridge.params_from_jax(jcp))
    jnmt = JNMT.from_config(cfg)
    jnp_ = jnmt.init_params(jax.random.PRNGKey(1))
    tnmt = NMTModel.from_config(cfg, device="cpu")
    tnmt.load_state_dict(bridge.params_from_jax(jnp_))
    rs = np.random.RandomState(5)
    fc = rs.randn(4, cfg.fc_feat_size).astype(np.float32)
    att = rs.randn(4, 5, cfg.att_feat_size).astype(np.float32)
    masks = np.ones((4, 5), np.float32)
    masks[2, 3:] = 0.0
    jf = JF(fc_feats=jnp.asarray(_bf16_np(fc)),
            att_feats=jnp.asarray(_bf16_np(att)), att_masks=jnp.asarray(masks))
    tf = Features(fc_feats=to_bfloat16(fc), att_feats=to_bfloat16(att),
                  att_masks=torch.from_numpy(masks))
    return cfg, (jcap, jcp, jnmt, jnp_, jf), (tcap, tnmt, tf)


def _same_tokens(got, want, logprobs, what):
    """Token-identical; a flip is reported with its logprob margin (the
    gap between the two chosen tokens' logprobs at the first differing
    step), never hidden."""
    got, want = np.asarray(got), np.asarray(want)
    if np.array_equal(got, want):
        return
    row, col = np.argwhere(got != want)[0][:2]
    margin = "not known"
    if logprobs is not None:
        lp = np.asarray(logprobs)[row, col]
        margin = f"{abs(lp[got[row, col]] - lp[want[row, col]]):.3g}"
    raise AssertionError(f"{what}: token flip at row {row}, step {col} "
                         f"(port {got[row, col]}, JAX {want[row, col]}; "
                         f"logprob margin {margin})")


class _topk_dtypes:
    """Records the dtype of every row the beam search gives `row_topk`."""

    def __enter__(self):
        from unpaired_image_captioning_tpu_torch.ops import beam_search

        self.mod, self.real, self.seen = beam_search, beam_search.row_topk, []

        def spy(x, k, *a, **kw):
            self.seen.append(x.dtype)
            return self.real(x, k, *a, **kw)

        beam_search.row_topk = spy
        return self.seen

    def __exit__(self, *exc):
        self.mod.row_topk = self.real


def test_bf16_feature_lstm_pivot_matches_jax():
    """The LSTM pivot (denseatt beam 3 -> BiLSTM NMT beam 3) and the greedy
    caption on bf16 features and f32 weights: bf16 memory and LSTM state,
    p_att widened before the decode loops; tokens identical."""
    import jax
    import jax.numpy as jnp

    from unpaired_image_captioning_tpu import pivot as jpivot
    from unpaired_image_captioning_tpu_torch import pivot as tpivot

    cfg, (jcap, jcp, jnmt, jnp_, jf), (tcap, tnmt, tf) = _decode_setup(
        "denseatt")
    cap2nmt = np.minimum(np.arange(cfg.vocab_size + 1),
                         cfg.nmt_src_vocab_size - 1)
    jzh, jen, _ = jax.jit(lambda cp, np_, f: jpivot.pivot_translate(
        jcap, cp, jnmt, np_, f, jnp.asarray(cap2nmt), cap_beam=3, nmt_beam=3,
        nmt_max_len=6))(jcp, jnp_, jf)
    with _topk_dtypes() as seen:
        tzh, ten, _ = tpivot.pivot_translate(tcap, tnmt, tf,
                                             torch.from_numpy(cap2nmt),
                                             cap_beam=3, nmt_beam=3,
                                             nmt_max_len=6)
    # B2 keeps no bf16 entry: the logprobs reaching the top-k are f32
    assert seen and set(seen) == {torch.float32}
    _same_tokens(tzh.numpy(), jzh, None, "pivot zh")
    _same_tokens(ten.numpy(), jen, None, "pivot en")
    jseq, jlp = jax.jit(lambda p, f: jcap.sample(
        p, f, jax.random.PRNGKey(0), greedy=True))(jcp, jf)
    tseq, tlp = tcap.sample(tf, greedy=True)
    _same_tokens(tseq.numpy(), jseq, None, "greedy")
    _close(tlp.numpy(), jlp, 1e-3, "greedy logprobs")
    assert tlp.dtype == torch.float32


def test_bf16_feature_transformer_beam_matches_jax():
    """The transformer captioner's beam 3 on bf16 features: both encoders
    keep them bf16 through f32 weights (`linear` keeps its input's type),
    the tokens are identical, and the logprobs that reach the beam's top-k
    are f32 on both bf16-feature routes."""
    import jax

    _, (jcap, jcp, _, _, jf), (tcap, _, tf) = _decode_setup("transformer")
    want = jax.jit(lambda p, f: jcap.sample_beam(p, f, beam_size=3))(jcp, jf)
    with _topk_dtypes() as seen:
        got = tcap.sample_beam(tf, beam_size=3)
    _same_tokens(got.seq.numpy(), want.seq, None, "transformer beam")
    assert seen and set(seen) == {torch.float32}


# ---------------------------------------------------------------------------
# (e) the plain versions of B1, B9a-c and B10 in each dtype mixture
# ---------------------------------------------------------------------------

DT = {"f32": np.float32, "bf16": "bf16"}
CELL_MIXES = [("f32", "f32", "f32"), ("f32", "f32", "bf16"),
              ("bf16", "f32", "bf16"), ("bf16", "bf16", "bf16"),
              ("f32", "bf16", "bf16")]


def _as(a, kind):
    """(the JAX array, the torch tensor) of `a` in f32 or bf16."""
    import jax.numpy as jnp

    from unpaired_image_captioning_tpu_torch.data.dataloader import (
        to_bfloat16)

    if kind == "bf16":
        return jnp.asarray(_bf16_np(a)), to_bfloat16(a)
    a = np.asarray(a, np.float32)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _tnp(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("maxout", [True, False])
@pytest.mark.parametrize("mix", CELL_MIXES, ids="/".join)
def test_lstm_cell_plain_mixtures_match_jax(mix, maxout):
    """B1's plain version, x / (w, b) / (h, c) each f32 or bf16, against
    `lstm_step_ref` with lstm_step's casts to the carry's types."""
    from unpaired_image_captioning_tpu.ops.rnn import lstm_step_ref

    b_, d, h = 5, 12, 8
    g = 5 if maxout else 4
    rs = np.random.RandomState(1)
    w, bias = rs.randn(d + h, g * h) * 0.3, rs.randn(g * h) * 0.1
    x, h0, c0 = rs.randn(b_, d), rs.randn(b_, h), rs.randn(b_, h)
    (jw, tw), (jb, tb) = _as(w, mix[1]), _as(bias, mix[1])
    jx, tx = _as(x, mix[0])
    (jh, th), (jc, tc) = _as(h0, mix[2]), _as(c0, mix[2])
    hj, cj = lstm_step_ref({"w": jw, "b": jb}, jx, jh, jc, maxout=maxout)
    hj, cj = hj.astype(jh.dtype), cj.astype(jc.dtype)
    ht, ct = lk.lstm_cell(tw, tb, tx, th, tc, maxout=maxout)
    assert ht.dtype == th.dtype and ct.dtype == tc.dtype
    _close(_tnp(ht), hj, BF16_TOL, "h")
    _close(_tnp(ct), cj, BF16_TOL, "c")
    with pytest.raises(ValueError, match="mixture"):
        lk.mixture(tx, tw, tb.double(), th, tc)


ATT_MIXES = [("f32",) * 5, ("f32", "bf16", "f32", "f32", "bf16"),
             ("bf16", "bf16", "bf16", "f32", "bf16"),
             ("f32", "bf16", "bf16", "f32", "bf16"),
             ("bf16", "bf16", "f32", "f32", "bf16")]


@pytest.mark.parametrize("k", [None, 3])
@pytest.mark.parametrize("mix", ATT_MIXES, ids="/".join)
def test_attention_plain_mixtures_match_jax(mix, k):
    """B9a / B9b's plain versions, p_att / q / alpha / mask / emb each f32
    or bf16, against `_reference_attention` / `_beams`."""
    from unpaired_image_captioning_tpu.ops import attention as jatt

    b_, n, a, d = 3, 6, 8, 10
    rs = np.random.RandomState(2)
    mask = np.ones((b_, n))
    mask[1, 4:] = 0.0
    raw = [rs.randn(b_, n, a), rs.randn(*((b_, a) if k is None
                                          else (b_, k, a))),
           rs.randn(a, 1) * 0.3, mask, rs.randn(b_, n, d)]
    pairs = [_as(v, m) for v, m in zip(raw, mix)]
    jfn = (jatt._reference_attention if k is None
           else jatt._reference_attention_beams)
    tfn = (tatt.reference_attention if k is None
           else tatt.reference_attention_beams)
    want = jfn(*(p[0] for p in pairs))
    got = tfn(*(p[1] for p in pairs))
    assert got.dtype == pairs[4][1].dtype
    _close(_tnp(got), want, BF16_TOL, "attention")


STEP_MIXES = [("f32",) * 9,
              ("f32", "bf16", "f32", "bf16", "bf16", "bf16", "f32", "f32",
               "f32"),
              ("f32", "bf16", "f32", "bf16", "bf16", "bf16", "bf16", "bf16",
               "bf16")]


@pytest.mark.parametrize("mix", STEP_MIXES, ids="/".join)
def test_step_plain_mixtures_match_jax(mix):
    """B9c's plain version in the decode routes' mixtures (p_att, emb,
    mask, q1, h0d, the carry, w1 / b1, the products, the alphas) against
    the Pallas kernel in interpret mode."""
    from unpaired_image_captioning_tpu.ops.attention import (
        fused_att_lstm_att)

    b_, n, a, d, h = 2, 5, 8, 8, 8
    rs = np.random.RandomState(3)
    mask = np.ones((b_, n))
    mask[1, 3:] = 0.0
    raw = [rs.randn(b_, n, a), rs.randn(b_, n, d), mask, rs.randn(b_, a),
           rs.randn(b_, h), rs.randn(b_, h), rs.randn(b_, h),
           rs.randn(2 * h + d, 5 * h) * 0.3, rs.randn(5 * h) * 0.1,
           rs.randn(d, h) * 0.3, rs.randn(h) * 0.1, rs.randn(h, a) * 0.3,
           rs.randn(a) * 0.1, rs.randn(a, 1) * 0.3, rs.randn(a, 1) * 0.3]
    groups = ((0,), (1,), (2,), (3,), (4,), (5, 6), (7, 8), (9, 10, 11, 12),
              (13, 14))
    kinds = [None] * 15
    for idx, m in zip(groups, mix):
        for i in idx:
            kinds[i] = m
    pairs = [_as(v, m) for v, m in zip(raw, kinds)]
    want = fused_att_lstm_att(*(p[0] for p in pairs), interpret=True)
    with torch.no_grad():
        got = aak.fused_att_lstm_att(*(p[1] for p in pairs))
    for gt, wt, name in zip(got, want, ("h1", "c1", "att2")):
        assert str(gt.dtype).endswith(str(wt.dtype)), name
        _close(_tnp(gt), wt, BF16_TOL, name)


CHAIN_MIXES = [("f32", "f32"), ("bf16", "bf16"), ("bf16", "f32"),
               ("f32", "bf16")]


@pytest.mark.parametrize("mix", CHAIN_MIXES, ids="/".join)
def test_chain_plain_mixtures_match_jax(mix):
    """B10's plain forward and backward (f32 x_contrib, the carry / w_h2h
    each f32 or bf16) against the per-step chain with the carry's casts
    each step, as `tests/test_lstm_block.py:29-40` scans `lstm_step_ref`
    (its input rows folded into x_contrib), and its autodiff."""
    import jax
    import jax.numpy as jnp

    from unpaired_image_captioning_tpu.ops.rnn import _lstm_elementwise

    t_, b_, d, h = 4, 3, 6, 8
    rs = np.random.RandomState(4)
    w = rs.randn(d + h, 5 * h) * 0.3
    xc = rs.randn(t_, b_, 5 * h).astype(np.float32)
    h0, c0 = rs.randn(b_, h) * 0.5, rs.randn(b_, h) * 0.5
    gh, gc = rs.randn(t_, b_, h), rs.randn(t_, b_, h) * 0.3
    (jw, tw), (jh, th), (jc, tc) = (_as(w[d:], mix[1]), _as(h0, mix[0]),
                                    _as(c0, mix[0]))

    def scan(xc_, h_, c_, w_):
        # gates = x_contrib + h @ w_h2h, the cell in f32, h and c cast to
        # the carry's types each step
        hs, cs = [], []
        hh, cc = h_, c_
        for t in range(t_):
            gates = xc_[t] + jnp.dot(hh, w_,
                                     preferred_element_type=jnp.float32)
            hn, cn = _lstm_elementwise(gates, cc.astype(jnp.float32), h, True)
            hh, cc = hn.astype(h_.dtype), cn.astype(c_.dtype)
            hs.append(hh)
            cs.append(cc)
        return jnp.stack(hs), jnp.stack(cs)

    def loss_j(xc_, h_, c_, w_):
        hs, cs = scan(xc_, h_, c_, w_)
        return (jnp.sum(hs.astype(jnp.float32) * gh)
                + jnp.sum(cs.astype(jnp.float32) * gc))

    hs_j, cs_j = scan(jnp.asarray(xc), jh, jc, jw)
    grads_j = jax.grad(loss_j, argnums=(0, 1, 2, 3))(jnp.asarray(xc), jh, jc,
                                                    jw)
    leaves = [torch.from_numpy(xc).requires_grad_(),
              th.requires_grad_(), tc.requires_grad_(), tw.requires_grad_()]
    hs_t, cs_t = lb.blocked_lstm_chain(*leaves, maxout=True)
    assert hs_t.dtype == th.dtype
    _close(_tnp(hs_t), hs_j, BF16_TOL, "hs")
    _close(_tnp(cs_t), cs_j, BF16_TOL, "cs")
    ((hs_t.float() * torch.from_numpy(gh).float()).sum()
     + (cs_t.float() * torch.from_numpy(gc).float()).sum()).backward()
    for leaf, want, name in zip(leaves, grads_j, ("dx", "dh0", "dc0", "dw")):
        assert leaf.grad.dtype == leaf.dtype, name
        _close(_tnp(leaf.grad), want, BF16_TOL, name)
    # the plain forward keeps the gates f32 and the carry in its type
    _, _, gates = tlo.chain_fwd_plain(leaves[0].detach(), th.detach(),
                                      tc.detach(), tw.detach(), maxout=True)
    assert gates.dtype == torch.float32


def test_promotion_traps_are_pinned():
    """Where torch and JAX promote differently, the port casts as JAX
    computes: a 0-d f32 tensor does not widen a bf16 tensor in torch (a
    non-weak f32 0-d array does in JAX), so `_masked_mean_var` widens the
    features itself; `torch.cat` promotes f32 with bf16 to f32 as
    `jnp.concatenate` does (lstm0's input [word; fc] is f32 with f32
    weights); torch.matmul refuses a mixture that `jnp.dot` promotes, so
    `models.base.mm` widens both."""
    import jax.numpy as jnp

    from unpaired_image_captioning_tpu_torch.models.att import (
        _masked_mean_var)
    from unpaired_image_captioning_tpu_torch.models.base import mm

    x = torch.ones(3, dtype=torch.bfloat16)
    assert (x * torch.tensor(2.0)).dtype == torch.bfloat16
    assert (jnp.ones(3, jnp.bfloat16) * jnp.asarray(2.0, jnp.float32)
            ).dtype == jnp.float32
    assert torch.cat([torch.ones(2), x]).dtype == torch.float32
    assert jnp.concatenate([jnp.ones(2), jnp.ones(3, jnp.bfloat16)]
                           ).dtype == jnp.float32
    with pytest.raises(RuntimeError):
        torch.ones(2, 3) @ torch.ones(3, 2, dtype=torch.bfloat16)
    assert mm(torch.ones(2, 3), torch.ones(3, 2, dtype=torch.bfloat16)
              ).dtype == torch.float32
    mean, var, n = _masked_mean_var(torch.randn(4, 5).to(torch.bfloat16),
                                    None)
    assert mean.dtype == var.dtype == torch.float32
