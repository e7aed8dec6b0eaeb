"""PyTorch port, the NMT options (copy attention, coverage, context gates,
the constrained / sparse attention transforms with constant, predicted and
guided fertility, mlp attention, no input feed, positional encoding,
shared decoder embeddings, the source embeddings MLP and source word
features) against the JAX package on the same parameters (carried over by
bridge.params_from_jax) and the same numpy inputs, dropout off:

- `init_params` keys and shapes equal JAX's;
- teacher-forced outputs, attentions and copy attentions within 1e-5, and
  one XE loss and its gradient (within 1e-4 x max(1, max |g|));
- `translate_batch` token-identical at beam 3 (scores within 1e-5);
- the copy generators (extended, fold, normalised), `copy_train_loss`,
  `extended_copy_targets` and `resolve_extended`, and the copy beam in
  both modes;
- the traps the JAX package pins: the <SINK> bound re-set to 100 before
  every step's attention, coverage that changes nothing unless
  `coverage_feed`; `remat`'s gradient equal to the plain one with dropout
  on; `NMTImageEncoder`; `from_config`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unpaired_image_captioning_tpu import constants as C
from unpaired_image_captioning_tpu.losses import criterion as jcrit
from unpaired_image_captioning_tpu.models import nmt as jnmt
from unpaired_image_captioning_tpu.utils import fertility as jfert
from unpaired_image_captioning_tpu_torch import bridge
from unpaired_image_captioning_tpu_torch.config import Config
from unpaired_image_captioning_tpu_torch.losses import criterion as tcrit
from unpaired_image_captioning_tpu_torch.models import nmt as tnmt
from unpaired_image_captioning_tpu_torch.utils import fertility as tfert

torch.set_num_threads(1)

SRC_V, TGT_V, B, S, T = 31, 29, 3, 6, 7
BASE = dict(src_vocab_size=SRC_V, tgt_vocab_size=TGT_V, word_vec_size=16,
            rnn_size=16, layers=1, dropout=0.0, max_decode_len=6)
FEATS = (7, 5)
VARIANTS = {
    "a-copy-gate-coverage-pe-shared": dict(
        copy_attn=True, context_gate="both", coverage_attn=True,
        position_encoding=True, share_decoder_embeddings=True),
    "b-csoftmax-predicted-features": dict(
        attn_transform="constrained_softmax", c_attn=0.2,
        predict_fertility=True, src_feature_sizes=FEATS,
        feature_vec_size=6),
    "c-csparsemax-guided-mlp-nofeed-covfeed": dict(
        attn_transform="constrained_sparsemax", attention_type="mlp",
        input_feed=0, coverage_attn=True, coverage_feed=True),
    "d-sparsemax": dict(attn_transform="sparsemax"),
    "e-embmlp-gate-source-fertility-2layers": dict(
        src_emb_mlp=True, context_gate="source",
        attn_transform="constrained_softmax", fertility=1.5, layers=2),
    "f-gate-target-mlp-copy-nofeed": dict(
        context_gate="target", attention_type="mlp", copy_attn=True,
        input_feed=0, word_vec_size=12),
}


def _inputs():
    rs = np.random.RandomState(2)
    lengths = np.array([S, 4, 2], np.int32)
    src = rs.randint(4, 12, (B, S)).astype(np.int32)   # repeats: copy slots
    src[np.arange(S)[None, :] >= lengths[:, None]] = C.PAD
    feats = np.stack([rs.randint(1, n, (B, S)) for n in FEATS],
                     -1).astype(np.int32)
    feats[src == C.PAD] = C.PAD
    tgt = np.zeros((B, T), np.int32)
    for i, n in enumerate((T - 2, 3, 1)):
        tgt[i, 0] = C.BOS
        tgt[i, 1:1 + n] = rs.randint(4, TGT_V, n)
        tgt[i, 1 + n] = C.EOS
    tgt[0, 2] = C.UNK                                    # a gold UNK
    # guided fertility: a table folded from seeded alignment lines
    align = [" ".join(f"{i}-{j}" for i, j in zip(
        rs.randint(0, lengths[b], 3), range(3))) for b in range(B)]
    table = jfert.alignment_fertilities(
        align, [list(r[:l]) for r, l in zip(src, lengths)], SRC_V)
    fert = jfert.batch_fertilities(table, src)
    # source -> target id map with unmapped words (PAD) for the copy paths
    s2t = np.full((SRC_V,), C.PAD, np.int32)
    s2t[4:9] = np.arange(10, 15)
    s2t[9] = C.UNK
    return dict(src=src, lengths=lengths, feats=feats, tgt=tgt, fert=fert,
                s2t=s2t)


class _Case:
    """One variant's JAX model, params and results, computed once."""

    def __init__(self, name, data):
        self.kw = {**BASE, **VARIANTS[name]}
        self.jm = jnmt.NMTModel(**self.kw)
        self.jp = self.jm.init_params(jax.random.PRNGKey(5))
        self.data = data
        self.extra = {}
        if "src_feature_sizes" in self.kw:
            self.extra["src_feats"] = data["feats"]
        if name.startswith("c-"):
            self.extra["src_fertilities"] = data["fert"]

    def port(self, **over):
        tm = tnmt.NMTModel(**{**self.kw, **over}, device="cpu")
        own = tm.state_dict()
        tm.load_state_dict({k: v for k, v in bridge.params_from_jax(
            self.jp).items() if k in own or not over})
        return tm

    def t_extra(self):
        return {k: torch.from_numpy(v).long() if v.dtype == np.int32
                else torch.from_numpy(v) for k, v in self.extra.items()}

    def j_extra(self):
        return {k: jnp.asarray(v) for k, v in self.extra.items()}


@pytest.fixture(scope="module")
def cases():
    data = _inputs()
    return {name: _Case(name, data) for name in VARIANTS}


def _t(a):
    return torch.from_numpy(np.asarray(a)).long()


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_init_params_keys_and_shapes_match_jax(cases, name):
    case = cases[name]
    with torch.no_grad():
        fresh = tnmt.NMTModel(**case.kw, device="cpu").init_params(
            torch.Generator().manual_seed(0))
    got = bridge.params_to_numpy(fresh)
    assert (jax.tree_util.tree_map(np.shape, got)
            == jax.tree_util.tree_map(np.shape, case.jp))
    lut = fresh.encoder.embeddings.word_lut.detach()
    assert float(lut[C.PAD].abs().max()) == 0.0


def _jax_loss(case):
    jm, d = case.jm, case.data

    def f(p):
        outs, att = jm.forward(p, jnp.asarray(d["src"]),
                               jnp.asarray(d["lengths"]),
                               jnp.asarray(d["tgt"]), **case.j_extra())
        loss, _ = jcrit.nmt_loss(jm.generator_logits(p, outs),
                                 jnp.asarray(d["tgt"])[:, 1:])
        return loss, (outs, att)

    return jax.jit(jax.value_and_grad(f, has_aux=True))(case.jp)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_forward_and_gradient_match_jax(cases, name):
    case = cases[name]
    d = case.data
    (jloss, (jouts, jatt)), jgrads = _jax_loss(case)
    tm = case.port()
    outs, att = tm.forward(_t(d["src"]), _t(d["lengths"]), _t(d["tgt"]),
                           **case.t_extra())
    loss, _ = tcrit.nmt_loss(tm.generator_logits(outs), _t(d["tgt"])[:, 1:])
    loss.backward()
    np.testing.assert_allclose(outs.detach().numpy(), np.asarray(jouts),
                               atol=1e-5)
    if case.kw.get("copy_attn"):
        att, copy = att
        jatt, jcopy = jatt
        np.testing.assert_allclose(copy.detach().numpy(), np.asarray(jcopy),
                                   atol=1e-5)
    np.testing.assert_allclose(att.detach().numpy(), np.asarray(jatt),
                               atol=1e-5)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    want = bridge.params_from_jax(jgrads)
    for k, p in tm.named_parameters():
        g = (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
        w = want[k].numpy()
        np.testing.assert_allclose(g, w, atol=1e-4 * max(1.0, np.abs(w).max()),
                                   err_msg=k)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_translate_matches_jax(cases, name):
    case = cases[name]
    d = case.data
    kw = {}
    if case.kw.get("copy_attn"):
        kw["src2tgt"] = d["s2t"]
    jr = jax.jit(lambda p, s, l: case.jm.translate_batch(
        p, s, l, beam_size=3,
        **{k: jnp.asarray(v) for k, v in kw.items()},
        **case.j_extra()))(case.jp, jnp.asarray(d["src"]),
                           jnp.asarray(d["lengths"]))
    with torch.no_grad():
        tr = case.port().translate_batch(_t(d["src"]), _t(d["lengths"]),
                                         beam_size=3, **kw,
                                         **case.t_extra())
    np.testing.assert_array_equal(tr.seq.numpy(), np.asarray(jr.seq))
    np.testing.assert_array_equal(tr.aux.numpy(), np.asarray(jr.aux))
    np.testing.assert_allclose(tr.scores.numpy(), np.asarray(jr.scores),
                               atol=1e-5)


def test_copy_generators_match_jax(cases):
    """Extended, fold and normalised copy logprobs over [B, T] and [B]
    rows, `copy_train_loss`, `extended_copy_targets`, the first-occurrence
    slots and `resolve_extended`."""
    case = cases["a-copy-gate-coverage-pe-shared"]
    jm, jp, d = case.jm, case.jp, case.data
    tm = case.port()
    rs = np.random.RandomState(4)
    outs = rs.randn(B, T - 1, 16).astype(np.float32)
    attn = rs.dirichlet(np.ones(S), (B, T - 1)).astype(np.float32)
    src, s2t = d["src"], d["s2t"]
    for fn in ("copy_generator_extended_logprobs",
               "copy_generator_fold_logprobs", "copy_generator_logprobs"):
        for o, a in ((outs, attn), (outs[:, 0], attn[:, 0])):
            want = getattr(jm, fn)(jp, jnp.asarray(o), jnp.asarray(a),
                                   jnp.asarray(src), jnp.asarray(s2t))
            with torch.no_grad():
                got = getattr(tm, fn)(torch.from_numpy(o),
                                      torch.from_numpy(a), _t(src), s2t)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-5, err_msg=fn)
    align = (rs.rand(B, T - 1, S) < 0.3).astype(np.float32)
    tgt = d["tgt"][:, 1:]
    jl, js = jm.copy_train_loss(jp, jnp.asarray(outs), jnp.asarray(attn),
                                jnp.asarray(tgt), jnp.asarray(align))
    with torch.no_grad():
        tl, ts = tm.copy_train_loss(torch.from_numpy(outs),
                                    torch.from_numpy(attn), _t(tgt),
                                    torch.from_numpy(align))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert (float(ts.n_words), float(ts.n_correct)) == (
        float(js.n_words), float(js.n_correct))
    alignment = rs.randint(-1, S, (B, T - 1)).astype(np.int32)
    np.testing.assert_array_equal(
        tm.extended_copy_targets(_t(tgt), _t(alignment), _t(src)).numpy(),
        np.asarray(jm.extended_copy_targets(jnp.asarray(tgt),
                                            jnp.asarray(alignment),
                                            jnp.asarray(src))))
    np.testing.assert_array_equal(
        tm.src_first_occurrence(_t(src)).numpy(),
        np.asarray(jm.src_first_occurrence(jnp.asarray(src))))
    seq = rs.randint(0, TGT_V + S, (B, 3, 5)).astype(np.int32)
    for got, want in zip(tm.resolve_extended(_t(seq)),
                         jm.resolve_extended(jnp.asarray(seq))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mode", ["extended", "fold"])
def test_copy_translate_modes_match_jax(cases, mode):
    """The copy beam in both modes with a generator tilted toward the copy
    gate, so that extended ids (exact copies) and UNK are decoded."""
    case = cases["f-gate-target-mlp-copy-nofeed"]
    d = case.data
    jp = dict(case.jp)
    jp["copy_gate"] = {**jp["copy_gate"],
                       "b": jp["copy_gate"]["b"] + 3.0}
    jr = jax.jit(lambda p, s, l, m: case.jm.translate_batch(
        p, s, l, beam_size=3, src2tgt=m, copy_mode=mode))(
        jp, jnp.asarray(d["src"]), jnp.asarray(d["lengths"]),
        jnp.asarray(d["s2t"]))
    tm = case.port()
    tm.load_state_dict(bridge.params_from_jax(jp))
    with torch.no_grad():
        tr = tm.translate_batch(_t(d["src"]), _t(d["lengths"]), beam_size=3,
                                src2tgt=d["s2t"], copy_mode=mode)
    np.testing.assert_array_equal(tr.seq.numpy(), np.asarray(jr.seq))
    np.testing.assert_allclose(tr.scores.numpy(), np.asarray(jr.scores),
                               atol=1e-5)
    if mode == "extended":
        assert int(tr.seq.max()) >= TGT_V          # an exact copy decoded


def _decode_steps(tm, d, n, **extra):
    with torch.no_grad():
        ctx, state = tm._encode(_t(d["src"]), _t(d["lengths"]), **extra)
        attns, states = [], []
        it = torch.full((B,), C.BOS, dtype=torch.long)
        for _ in range(n):
            out, attn, state = tm.decoder.step(ctx, state, it)
            it = tm.generator_logits(out).argmax(-1)
            attns.append(attn)
            states.append(state)
    return attns, states


def test_sink_bound_is_repinned_every_step(cases):
    """The constrained route's attention after 3 steps equals JAX's, and
    the <SINK> (last) column of the bounds the attention reads is 100 each
    step, though the state after a step holds 100 - attn there."""
    case = cases["e-embmlp-gate-source-fertility-2layers"]
    d = case.data
    tm = case.port()
    attns, states = _decode_steps(tm, d, 3)
    jm, jp = case.jm, case.jp
    jctx, jhid = jm.encoder.apply(jp["encoder"], jnp.asarray(d["src"]),
                                  jnp.asarray(d["lengths"]))
    jst = jm.decoder.init_state(jhid, jctx)
    it = jnp.full((B,), C.BOS, jnp.int32)
    for k in range(3):
        jout, jattn, jst = jm.decoder.step(jp["decoder"], jctx, jst, it)
        it = jnp.argmax(jm.generator_logits(jp, jout), -1)
        np.testing.assert_allclose(attns[k].numpy(), np.asarray(jattn),
                                   atol=1e-5)
        np.testing.assert_allclose(states[k]["upper_bounds"].numpy(),
                                   np.asarray(jst["upper_bounds"]),
                                   atol=1e-5)
        sink = states[k]["upper_bounds"][:, -1]
        np.testing.assert_allclose(sink.numpy(),
                                   100.0 - attns[k][:, -1].numpy(),
                                   rtol=1e-6)


def test_coverage_changes_attention_only_when_fed_back(cases):
    case = cases["c-csparsemax-guided-mlp-nofeed-covfeed"]
    d = case.data
    ex = {"src_fertilities": torch.from_numpy(d["fert"])}
    fed, _ = _decode_steps(case.port(), d, 3, **ex)
    plain, st = _decode_steps(case.port(coverage_feed=False), d, 3, **ex)
    bare, _ = _decode_steps(case.port(coverage_feed=False,
                                      coverage_attn=False), d, 3, **ex)
    for a, b in zip(plain, bare):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_allclose(st[-1]["coverage"].numpy(),
                               sum(a.numpy() for a in plain), rtol=1e-6)
    assert not torch.equal(fed[-1], plain[-1])


def test_remat_gradient_equals_plain_with_dropout():
    """`remat` recomputes each decoder step in the backward; with dropout
    on, the recompute draws the forward's masks, so the gradient (and the
    generator's state after the step) equal those without `remat`."""
    kw = {**BASE, **VARIANTS["a-copy-gate-coverage-pe-shared"],
          "dropout": 0.3, "layers": 2}
    d = _inputs()
    grads, gen_states = [], []
    for remat in (False, True):
        tm = tnmt.NMTModel(**kw, remat=remat, device="cpu").init_params(
            torch.Generator().manual_seed(1))
        gen = torch.Generator().manual_seed(9)
        outs, _ = tm.forward(_t(d["src"]), _t(d["lengths"]), _t(d["tgt"]),
                             training=True, generator=gen)
        loss, _ = tcrit.nmt_loss(tm.generator_logits(outs),
                                 _t(d["tgt"])[:, 1:])
        loss.backward()
        grads.append({k: p.grad.clone() for k, p in tm.named_parameters()
                      if p.grad is not None})
        gen_states.append(gen.get_state())
    assert grads[0].keys() == grads[1].keys()
    for k, g in grads[0].items():
        tol = 1e-4 * max(1.0, float(g.abs().max()))
        np.testing.assert_allclose(grads[1][k].numpy(), g.numpy(), atol=tol,
                                   err_msg=k)
    assert torch.equal(gen_states[0], gen_states[1])


def test_image_encoder_matches_jax():
    enc = jnmt.NMTImageEncoder(feat_size=10, rnn_size=12, layers=1)
    jp = enc.init_params(jax.random.PRNGKey(2))
    grid = np.random.RandomState(3).randn(2, 3, 4, 10).astype(np.float32)
    jctx, (jh, jc) = jax.jit(enc.apply)(jp, jnp.asarray(grid))
    te = tnmt.NMTImageEncoder(feat_size=10, rnn_size=12, layers=1,
                              device="cpu")
    te.load_state_dict(bridge.params_from_jax(jp))
    with torch.no_grad():
        ctx, (h, c) = te.apply(torch.from_numpy(grid))
    for got, want in ((ctx, jctx), (h, jh), (c, jc)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    fresh = tnmt.NMTImageEncoder(feat_size=10, rnn_size=12, device="cpu")
    fresh.init_params(torch.Generator().manual_seed(0))
    assert (jax.tree_util.tree_map(np.shape, bridge.params_to_numpy(fresh))
            == jax.tree_util.tree_map(np.shape, jp))


def test_from_config_builds_every_option():
    cfg = Config(nmt_src_vocab_size=SRC_V, nmt_tgt_vocab_size=TGT_V,
                 word_vec_size=16, rnn_size=16, copy_attn=True,
                 coverage_attn=True, coverage_feed=True, context_gate="both",
                 attention_type="mlp", attn_transform="constrained_softmax",
                 c_attn=0.1, fertility=1.5, position_encoding=True,
                 share_decoder_embeddings=True, predict_fertility=True,
                 nmt_src_feature_sizes=(4, 3), feature_vec_size=5,
                 truncated_decoder=2)
    m = tnmt.NMTModel.from_config(cfg, device="cpu")
    j = jnmt.NMTModel.from_config(cfg)
    for k in ("copy_attn", "coverage_feed", "predict_fertility",
              "truncated_decoder", "share_decoder_embeddings"):
        assert getattr(m, k) == getattr(j, k)
    args = dict(m.init_args)
    assert args["src_feature_sizes"] == (4, 3)
    assert tnmt.NMTModel(**args, device="cpu").init_args == args
    assert (jax.tree_util.tree_map(
        np.shape, bridge.params_to_numpy(m.init_params(
            torch.Generator().manual_seed(0))))
        == jax.tree_util.tree_map(
            np.shape, j.init_params(jax.random.PRNGKey(0))))


def test_fertility_tables_match_jax(tmp_path):
    from unpaired_image_captioning_tpu.vocab import Dict as JDict
    from unpaired_image_captioning_tpu_torch.vocab import Dict as TDict

    rs = np.random.RandomState(6)
    words = [f"w{i}" for i in range(12)]
    lines = [" ".join(rs.choice(words, rs.randint(2, 7))) for _ in range(9)]
    aligns = [" ".join(f"{rs.randint(0, len(l.split()) + 1)}-{j}"
                       for j in range(rs.randint(0, 5))) for l in lines]
    (tmp_path / "src.txt").write_text("\n".join(lines) + "\n")
    (tmp_path / "align.txt").write_text("\n".join(aligns) + "\n")
    tables = []
    for D in (JDict, TDict):
        dct = D([C.PAD_WORD, C.UNK_WORD, C.BOS_WORD, C.EOS_WORD])
        for w in words[:9]:                   # w9..w11 map to UNK
            dct.add(w)
        tables.append((D.__module__.split(".")[0], dct))
    got = tfert.fert_table_from_files(str(tmp_path / "align.txt"),
                                      str(tmp_path / "src.txt"),
                                      tables[1][1], default=0.5)
    want = jfert.fert_table_from_files(str(tmp_path / "align.txt"),
                                       str(tmp_path / "src.txt"),
                                       tables[0][1], default=0.5)
    np.testing.assert_array_equal(got, want)
    assert got.max() > 1.0
    ids = rs.randint(0, len(got), (3, 5))
    np.testing.assert_array_equal(tfert.batch_fertilities(got, ids),
                                  jfert.batch_fertilities(want, ids))


def test_attention_criteria_match_jax():
    rs = np.random.RandomState(8)
    ub = rs.randn(B, T, S).astype(np.float32)
    cov = rs.rand(B, T, S).astype(np.float32) * 2
    att = rs.rand(B, T, S).astype(np.float32)
    for shard in (2, 3, T):
        np.testing.assert_allclose(
            float(tcrit.ref_exhaustion_loss(torch.from_numpy(ub),
                                            shard_size=shard,
                                            lambda_exhaust=0.4)),
            float(jcrit.ref_exhaustion_loss(jnp.asarray(ub),
                                            shard_size=shard,
                                            lambda_exhaust=0.4)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        float(tcrit.ref_coverage_loss(torch.from_numpy(cov),
                                      torch.from_numpy(att),
                                      lambda_coverage=0.7)),
        float(jcrit.ref_coverage_loss(jnp.asarray(cov), jnp.asarray(att),
                                      lambda_coverage=0.7)), rtol=1e-5, atol=1e-6)
    for kw in (dict(upper_bounds=ub[:, -1]), dict(coverage=cov[:, -1]),
               dict(upper_bounds=ub[:, -1], coverage=cov[:, -1],
                    lambda_exhaust=0.3)):
        want = jcrit.attention_regularizers(
            jnp.asarray(att), **{k: jnp.asarray(v) if isinstance(
                v, np.ndarray) else v for k, v in kw.items()})
        got = tcrit.attention_regularizers(
            torch.from_numpy(att), **{k: torch.from_numpy(v) if isinstance(
                v, np.ndarray) else v for k, v in kw.items()})
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-6)
