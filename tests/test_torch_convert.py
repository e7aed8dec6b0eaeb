"""The port's reference-checkpoint conversion (`models/convert.py`,
`NMTDataset.from_reference_pt`, `scripts/migrate_reference.py`) against the
JAX package on the CPU.

- Every `CONVERTERS` entry, `convert_fork_transformer` and
  `convert_nmt_model` (plain, source-feature LUTs, the embeddings MLP, and
  mlp attention with coverage, a context gate, copy attention and the
  fertility head) produce JAX's tree exactly (keys, dtypes, values) from
  generated reference-layout state dicts.
- Converted denseatt, stackatt and transformer captioners and the BiLSTM
  NMT decode token-identically in both packages, greedy and beam.
- `from_reference_pt` and `migrate_reference` on a generated reference
  corpus (with a py2-style `infos.pkl`, protocol 2) agree with JAX's: the
  padded corpus, the dicts, the infos and the converted weights.
"""

import argparse
import json
import pickle

import numpy as np
import pytest
import torch

from unpaired_image_captioning_tpu_torch import bridge
from unpaired_image_captioning_tpu_torch import models as tmodels
from unpaired_image_captioning_tpu_torch.config import Config as TConfig
from unpaired_image_captioning_tpu_torch.data.nmt_dataset import NMTDataset
from unpaired_image_captioning_tpu_torch.models import convert as tconv
from unpaired_image_captioning_tpu_torch.models.base import (
    Features as TFeatures)
from unpaired_image_captioning_tpu_torch.models.nmt import NMTModel
from unpaired_image_captioning_tpu_torch.scripts import migrate_reference

torch.set_num_threads(1)
# widths: vocab + 1 rows, word, hidden, attention hidden, fc, att, layers
V1, E, H, A, FC, ATT, NL = 13, 8, 8, 6, 10, 7, 2
SV, TV = 11, 12          # NMT source and target vocabularies


class _Ref:
    """A reference-layout state dict built name by name (torch's shapes:
    Linear weight [out, in]), float32 from a seeded stream."""

    def __init__(self, seed):
        self.rs = np.random.RandomState(seed)
        self.d = {}

    def t(self, name, *shape):
        self.d[name] = (self.rs.randn(*shape) * 0.3).astype(np.float32)

    def lin(self, p, i, o, bias=True):
        self.t(p + ".weight", o, i)
        if bias:
            self.t(p + ".bias", o)

    def maxout(self, p, i, h):
        self.lin(p + ".i2h", i, 5 * h)
        self.lin(p + ".h2h", h, 5 * h)

    def lstmcell(self, p, i, h, suffix="", bias=True):
        self.t(f"{p}.weight_ih{suffix}", 4 * h, i)
        self.t(f"{p}.weight_hh{suffix}", 4 * h, h)
        if bias:
            self.t(f"{p}.bias_ih{suffix}", 4 * h)
            self.t(f"{p}.bias_hh{suffix}", 4 * h)

    def bn(self, p, c):
        for k in ("weight", "bias", "running_mean"):
            self.t(f"{p}.{k}", c)
        self.d[f"{p}.running_var"] = (self.rs.rand(c) + 0.5).astype(
            np.float32)

    def attention(self, p):
        self.lin(p + ".h2att", H, A)
        self.lin(p + ".alpha_net", A, 1)

    def att_base(self, att_embed=True, bn=False):
        self.t("embed.0.weight", V1, E)
        self.lin("fc_embed.0", FC, H)
        if bn:
            self.bn("att_embed.0", ATT)
            self.lin("att_embed.1", ATT, H)
            self.bn("att_embed.4", H)
        elif att_embed:
            self.lin("att_embed.0", ATT, H)
        self.lin("ctx2att", H, A)
        self.lin("logit", H, V1)


def ref_fc(seed):
    r = _Ref(seed)
    r.lin("img_embed", FC, E)
    r.t("embed.weight", V1, E)
    r.maxout("core", E, H)
    r.lin("logit", H, V1)
    return r.d


def ref_topdown(seed, bn=False):
    r = _Ref(seed)
    r.att_base(bn=bn)
    r.lstmcell("core.att_lstm", E + 2 * H, H)
    r.lstmcell("core.lang_lstm", 2 * H, H)
    r.attention("core.attention")
    return r.d


def ref_att2(seed, kind):
    r = _Ref(seed)
    if kind == "att2in":
        r.t("embed.weight", V1, E)
        r.lin("ctx2att", ATT, A)
        r.lin("logit", H, V1)
    else:
        r.t("embed.0.weight", V1, E)
        r.lin("att_embed.0", ATT, H)
        r.lin("ctx2att", H, A)
        r.lin("logit", H, V1)
    r.maxout("core", E, H)
    r.lin("core.a2h" if kind == "att2all2" else "core.a2c", H,
          (5 if kind == "att2all2" else 2) * H)
    r.attention("core.attention")
    return r.d


def ref_adaatt(seed, layers, gates=5):
    r = _Ref(seed)
    r.att_base()
    r.lin("core.lstm.w2h", E, gates * H)
    r.lin("core.lstm.v2h", H, gates * H)
    for i in range(layers):
        r.lin(f"core.lstm.h2h.{i}", H, gates * H)
    for i in range(layers - 1):
        r.lin(f"core.lstm.i2h.{i}", H, gates * H)
    r.lin("core.lstm.r_h2h", H, H)
    if layers == 1:
        r.lin("core.lstm.r_w2h", E, H)
        r.lin("core.lstm.r_v2h", H, H)
    else:
        r.lin("core.lstm.r_i2h", H, H)
    for k in ("fr_linear.0", "ho_linear.0"):
        r.lin("core.attention." + k, H, H)
    for k in ("fr_embed", "ho_embed"):
        r.lin("core.attention." + k, H, A)
    r.lin("core.attention.alpha_net", A, 1)
    r.lin("core.attention.att2h", H, H)
    return r.d


def ref_show_tell(seed):
    r = _Ref(seed)
    r.lin("img_embed", FC, E)
    r.t("embed.weight", V1, E)
    for k in range(NL):
        r.lstmcell("core", E if k == 0 else H, H, suffix=f"_l{k}", bias=False)
    r.lin("logit", H, V1)
    return r.d


def ref_show_attend_tell(seed, all_img=False):
    r = _Ref(seed)
    r.lin("linear", FC, H)
    r.t("embed.weight", V1, E)
    r.lstmcell("core.rnn", E + (FC if all_img else ATT), H, suffix="_l0",
               bias=False)
    if not all_img:
        r.lin("core.ctx2att", ATT, A)
        r.lin("core.h2att", H, A)
        r.lin("core.alpha_net", A, 1)
    r.lin("logit", H, V1)
    return r.d


def ref_stack(seed, kind):
    r = _Ref(seed)
    r.att_base()
    for i in range(3):
        # stackcap's lstm1 / lstm2 also take the word + attribute input
        r.maxout(f"core.lstm{i}", E + 2 * H if kind == "stackcap" and i
                 else 2 * H, H)
    r.attention("core.att1")
    r.attention("core.att2")
    if kind != "stackcap":
        r.lin("core.emb2", H, H)
    if kind != "stackatt":
        r.lin("core.fusion1.0", 2 * H, H)
        r.lin("core.fusion2.0", 3 * H, H)
    if kind == "stackcap":
        r.lin("attri_embed.0", 16, H, bias=False)
    return r.d


def _ref_ln(r, p, d):
    r.t(p + ".a_2", d)
    r.t(p + ".b_2", d)


def ref_transformer(seed, layers=NL):
    r = _Ref(seed)
    r.lin("att_embed.0", ATT, H)
    r.t("model.tgt_embed.0.lut.weight", V1, H)
    r.lin("model.generator.proj", H, V1)
    _ref_ln(r, "model.encoder.norm", H)
    _ref_ln(r, "model.decoder.norm", H)
    for i in range(layers):
        for side, attns, norms in (("encoder", ("self_attn",), 2),
                                   ("decoder", ("self_attn", "src_attn"), 3)):
            p = f"model.{side}.layers.{i}"
            for a in attns:
                for j in range(4):
                    r.lin(f"{p}.{a}.linears.{j}", H, H)
            r.lin(p + ".feed_forward.w_1", H, 2 * H)
            r.lin(p + ".feed_forward.w_2", 2 * H, H)
            for j in range(norms):
                _ref_ln(r, f"{p}.sublayer.{j}.norm", H)
    return r.d


def ref_fork_transformer(seed, layers=NL):
    r = _Ref(seed)
    r.t("encoder.embeddings.word_lut.weight", SV, H)
    r.t("decoder.embeddings.word_lut.weight", TV, H)
    r.lin("generator.0", H, TV)
    for i in range(layers):
        for side, attns in (("encoder", ("self_attn",)),
                            ("decoder", ("self_attn", "context_attn"))):
            p = f"{side}.transformer.{i}"
            for a in attns:
                for k in ("query", "keys", "values"):
                    r.lin(f"{p}.{a}.linear_{k}", H, H, bias=False)
                _ref_ln(r, f"{p}.{a}.layer_norm", H)
            r.lin(p + ".feed_forward.w_1", H, 2 * H)
            r.lin(p + ".feed_forward.w_2", 2 * H, H)
            _ref_ln(r, p + ".feed_forward.layer_norm", H)
    return r.d


def ref_nmt(seed, variant="plain", layers=1):
    r = _Ref(seed)
    r.t("encoder.embeddings.word_lut.weight", SV, E)
    r.t("decoder.embeddings.word_lut.weight", TV, E)
    if variant == "features":
        r.t("encoder.embeddings.feature_luts.0.weight", 3, E)
        r.t("encoder.embeddings.feature_luts.1.weight", 5, E)
    if variant == "mlp_embeddings":
        r.lin("encoder.embeddings.linear", E, E)
    for l in range(layers):
        for sfx in ("", "_reverse"):
            r.lstmcell("encoder.rnn", E if l == 0 else H, H // 2,
                       suffix=f"_l{l}{sfx}")
        r.lstmcell(f"decoder.rnn.layers.{l}", E + H if l == 0 else H, H)
    if variant == "extras":
        for k in ("linear_context", "linear_query"):
            r.lin("decoder.attn." + k, H, H, bias=k == "linear_query")
            r.lin("decoder.copy_attn." + k, H, H, bias=k == "linear_query")
        r.lin("decoder.attn.v", H, 1, bias=False)
        r.lin("decoder.copy_attn.v", H, 1, bias=False)
        r.lin("decoder.attn.linear_cover", 1, H, bias=False)
        gp = "decoder.context_gate.context_gate"
        r.lin(gp + ".gate", E + 2 * H, H)
        r.lin(gp + ".source_proj", H, H)
        r.lin(gp + ".target_proj", E + H, H)
        r.lin("encoder.fertility_linear", H, 2 * H)
        r.lin("encoder.fertility_linear_2", 2 * H, 2 * H)
        r.lin("encoder.fertility_out", 2 * H, 1, bias=False)
        r.lin("generator.linear", H, TV)
        r.lin("generator.linear_copy", H, 1)
    else:
        r.lin("decoder.attn.linear_in", H, H, bias=False)
        r.lin("decoder.attn.linear_out", 2 * H, H, bias=False)
        r.lin("generator.0", H, TV)
    return r.d


# CONVERTERS name -> (generator, converter kwargs)
REFS = {
    "fc": (ref_fc, {}),
    "topdown": (ref_topdown, {}),
    "att2in2": (lambda s: ref_att2(s, "att2in2"), {}),
    "att2in": (lambda s: ref_att2(s, "att2in"), {}),
    "att2all2": (lambda s: ref_att2(s, "att2all2"), {}),
    "adaatt": (lambda s: ref_adaatt(s, 1, gates=4), {}),
    "adaattmo": (lambda s: ref_adaatt(s, 1), {}),
    "show_tell": (ref_show_tell, {}),
    "show_attend_tell": (ref_show_attend_tell, {}),
    "all_img": (lambda s: ref_show_attend_tell(s, all_img=True), {}),
    "stackatt": (lambda s: ref_stack(s, "stackatt"), {}),
    "denseatt": (lambda s: ref_stack(s, "denseatt"), {}),
    "stackcap": (lambda s: ref_stack(s, "stackcap"), {}),
    "transformer": (ref_transformer, {"num_layers": NL}),
}


def _flat(tree):
    return {k: v.numpy() for k, v in bridge.params_from_jax(tree).items()}


def _same_tree(got, want):
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].dtype == w[k].dtype, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_converters_cover_jax():
    from unpaired_image_captioning_tpu.models import convert as jconv

    assert sorted(tconv.CONVERTERS) == sorted(jconv.CONVERTERS) == sorted(
        REFS)


@pytest.mark.parametrize("name", sorted(REFS) + ["topdown_bn"])
def test_converter_tree_matches_jax(name):
    from unpaired_image_captioning_tpu.models import convert as jconv

    if name == "topdown_bn":
        key, state, kw = "topdown", ref_topdown(1, bn=True), {}
    else:
        make, kw = REFS[name]
        key, state = name, make(1)
    _same_tree(tconv.CONVERTERS[key](state, **kw),
               jconv.CONVERTERS[key](state, **kw))


def test_fork_transformer_tree_matches_jax():
    from unpaired_image_captioning_tpu.models import convert as jconv

    state = ref_fork_transformer(2)
    _same_tree(tconv.convert_fork_transformer(state, num_layers=NL),
               jconv.convert_fork_transformer(state, num_layers=NL))


@pytest.mark.parametrize("variant,layers,brnn", [
    ("plain", 1, True), ("plain", 2, True), ("features", 1, True),
    ("mlp_embeddings", 1, True), ("extras", 1, True), ("plain", 1, False)])
def test_nmt_tree_matches_jax(variant, layers, brnn):
    from unpaired_image_captioning_tpu.models import convert as jconv

    state = ref_nmt(3, variant, layers)
    if not brnn:
        state = {k: v for k, v in state.items() if "_reverse" not in k}
    _same_tree(tconv.convert_nmt_model(state, layers=layers, brnn=brnn),
               jconv.convert_nmt_model(state, layers=layers, brnn=brnn))


# ---------------------------------------------------------------------------
# converted weights decode token-identically in both packages
# ---------------------------------------------------------------------------

CAP_CFG = dict(vocab_size=V1 - 1, input_encoding_size=E, rnn_size=H,
               att_hid_size=A, num_layers=NL, num_heads=2, fc_feat_size=FC,
               att_feat_size=ATT, seq_length=7, drop_prob_lm=0.0)
B, N, BEAM = 3, 5, 2


def _sharpen(state, name):
    """Steeper logits, so that greedy and beam picks are far from ties."""
    state = dict(state)
    key = "model.generator.proj.weight" if name == "transformer" else \
        "logit.weight"
    state[key] = state[key] * 12.0
    if name == "fc":
        # fc sees the image once, at t = 0: a louder image embedding keeps
        # its captions apart
        state["img_embed.weight"] = state["img_embed.weight"] * 8.0
    return state


# the widths a family's generated reference fixes apart from CAP_CFG's
FAMILY_CFG = {"transformer": {"rnn_size": 2 * H}, "adaatt": {"num_layers": 1},
              "stackcap": {"attri_feat_size": 16}}


@pytest.mark.parametrize("name", ["denseatt", "stackatt", "transformer", "fc",
                                  "topdown", "adaatt", "stackcap"])
def test_converted_captioner_decodes_as_jax(name):
    import jax
    import jax.numpy as jnp

    from unpaired_image_captioning_tpu import models as jmodels
    from unpaired_image_captioning_tpu.config import Config
    from unpaired_image_captioning_tpu.models import convert as jconv
    from unpaired_image_captioning_tpu.models.base import Features

    make, kw = REFS[name]
    state = _sharpen(make(4), name)
    jtree = jconv.CONVERTERS[name](state, **kw)
    # the transformer's d_ff is rnn_size (2H in the reference layout)
    cfg = dict(CAP_CFG, caption_model=name, **FAMILY_CFG.get(name, {}))
    tm = tmodels.setup(TConfig(**cfg), device="cpu")
    tm.load_state_dict(bridge.params_from_jax(
        tconv.CONVERTERS[name](state, **kw)))
    jm = jmodels.setup(Config(**cfg))

    rs = np.random.RandomState(5)
    fc = rs.randn(B, FC).astype(np.float32)
    att = rs.randn(B, N, ATT).astype(np.float32)
    masks = np.ones((B, N), np.float32)
    masks[0, 3:] = 0.0
    jf = Features(fc_feats=jnp.asarray(fc), att_feats=jnp.asarray(att),
                  att_masks=jnp.asarray(masks))
    tf = TFeatures(fc_feats=torch.from_numpy(fc),
                   att_feats=torch.from_numpy(att),
                   att_masks=torch.from_numpy(masks))
    jseq, _ = jm.sample(jtree, jf, jax.random.PRNGKey(0))
    with torch.no_grad():
        tseq = tm.sample(tf, greedy=True)[0]
        tbeam = tm.sample_beam(tf, beam_size=BEAM)
    np.testing.assert_array_equal(tseq.numpy(), np.asarray(jseq))
    jbeam = jm.sample_beam(jtree, jf, beam_size=BEAM)
    np.testing.assert_array_equal(tbeam.seq.numpy(), np.asarray(jbeam.seq))
    if name != "transformer":   # its random layers give one caption for all
        assert len(set(map(tuple, tseq.numpy()))) > 1


def test_converted_nmt_translates_as_jax():
    import jax.numpy as jnp

    from unpaired_image_captioning_tpu.models import convert as jconv
    from unpaired_image_captioning_tpu.models.nmt import NMTModel as JNMT

    state = ref_nmt(6)
    state["generator.0.weight"] = state["generator.0.weight"] * 12.0
    kw = dict(src_vocab_size=SV, tgt_vocab_size=TV, word_vec_size=E,
              rnn_size=H, layers=1, dropout=0.0)
    tn = NMTModel(**kw, device="cpu")
    tn.load_state_dict(bridge.params_from_jax(
        tconv.convert_nmt_model(state)))
    jn = JNMT(**kw)
    jp = jconv.convert_nmt_model(state)
    src = np.array([[4, 5, 6, 7], [8, 9, 0, 0], [10, 4, 5, 0]], np.int64)
    lengths = (src != 0).sum(1)
    got = tn.translate_batch(torch.from_numpy(src),
                             torch.from_numpy(lengths), beam_size=3,
                             max_len=6)
    want = jn.translate_batch(jp, jnp.asarray(src, jnp.int32),
                              jnp.asarray(lengths, jnp.int32), beam_size=3,
                              max_len=6)
    np.testing.assert_array_equal(got.seq.numpy(), np.asarray(want.seq))
    np.testing.assert_array_equal(got.aux.numpy(), np.asarray(want.aux))


# ---------------------------------------------------------------------------
# the reference corpus and the migration
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """A reference run's artifacts: denseatt and NMT `.pth` state dicts,
    a py2-style infos.pkl (protocol 2), the wtoi pickle and the
    `nmt.train.pt` corpus with onmt-style dicts."""
    tmp = tmp_path_factory.mktemp("reference")
    torch.save({k: torch.from_numpy(v) for k, v in ref_stack(7,
                                                              "denseatt")
                .items()}, tmp / "model_i2t-best.pth")
    torch.save({"model": {k: torch.from_numpy(v)
                          for k, v in ref_nmt(8).items()}},
               tmp / "model_nmt-best.pth")
    opt = argparse.Namespace(caption_model="denseatt", rnn_size=H,
                             input_encoding_size=E, att_hid_size=A,
                             num_layers=NL, fc_feat_size=FC,
                             att_feat_size=ATT, seq_length=7,
                             gpus=[0, 1], not_a_field=3)
    with open(tmp / "infos-best.pkl", "wb") as f:
        pickle.dump({"opt": opt, "iter": 41, "epoch": 5,
                     "vocab": {str(i): f"w{i}" for i in range(1, V1)}},
                    f, protocol=2)
    with open(tmp / "wtoi_zh.txt", "wb") as f:
        pickle.dump({f"w{i}": i for i in range(1, V1)}, f, protocol=2)
    rs = np.random.RandomState(9)
    srcs = [torch.from_numpy(rs.randint(4, SV, rs.randint(1, 6)))
            for _ in range(9)]
    tgts = [torch.from_numpy(np.concatenate(
        [[2], rs.randint(4, TV, rs.randint(1, 7)), [3]])) for _ in range(9)]
    blob = {"train": {"src": srcs, "tgt": tgts},
            "valid": {"src": srcs[:2], "tgt": tgts[:2]},
            "dicts": {"src": {0: "<blank>", 1: "<unk>", 2: "<s>", 3: "</s>",
                              **{i: f"w{i}" for i in range(4, SV)}},
                      "tgt": {0: "<blank>", 1: "<unk>", 2: "<s>", 3: "</s>",
                              **{i: f"t{i}" for i in range(4, TV)}}}}
    torch.save(blob, tmp / "nmt.train.pt")
    return tmp


def test_from_reference_pt_matches_jax(reference_run):
    from unpaired_image_captioning_tpu.data.nmt_dataset import (
        NMTDataset as JNMT)

    path = str(reference_run / "nmt.train.pt")
    got = NMTDataset.from_reference_pt(path, 4, shuffle=True, seed=3)
    want = JNMT.from_reference_pt(path, 4, shuffle=True, seed=3)
    for k in ("src", "tgt", "order"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    for _ in range(3):
        (gb, gw), (wb, ww) = got.next_batch(), want.next_batch()
        assert gw == ww and sorted(gb) == sorted(wb)
        for k in gb:
            np.testing.assert_array_equal(gb[k], np.asarray(wb[k]))


def test_migrate_reference_matches_jax(reference_run, tmp_path):
    import h5py

    from unpaired_image_captioning_tpu.scripts import (
        migrate_reference as jmigrate)
    from unpaired_image_captioning_tpu.train.checkpoint import load_pytree

    r = reference_run
    argv = ["--caption_model", "denseatt",
            "--i2t_pth", str(r / "model_i2t-best.pth"),
            "--nmt_pth", str(r / "model_nmt-best.pth"),
            "--infos_pkl", str(r / "infos-best.pkl"),
            "--wtoi_zh", str(r / "wtoi_zh.txt"),
            "--nmt_pt", str(r / "nmt.train.pt")]
    port, jax_dir = tmp_path / "port", tmp_path / "jax"
    migrate_reference.main(["--out_dir", str(port)] + argv)
    jmigrate.main(["--out_dir", str(jax_dir)] + argv)

    assert not (port / "nmt_config.json").exists()
    for name in ("infos-best.json", "src_dict.json", "tgt_dict.json"):
        assert json.load(open(port / name)) == json.load(open(jax_dir / name))
    infos = json.load(open(port / "infos-best.json"))
    assert infos["iter"] == 41 and infos["opt"]["rnn_size"] == H
    assert "not_a_field" not in infos["opt"]
    corpus = np.load(port / "nmt.train.npz")
    with h5py.File(jax_dir / "nmt.train.h5", "r") as f:
        for k in ("src", "tgt"):
            np.testing.assert_array_equal(corpus[k], f[k][...])
    # the weights: the port's .pt state dicts are JAX's trees, flattened
    for name, make in (("model_i2t", tmodels.setup(TConfig(
            caption_model="denseatt", **CAP_CFG), device="cpu")),
                       ("model_nmt", NMTModel(
                           src_vocab_size=SV, tgt_vocab_size=TV,
                           word_vec_size=E, rnn_size=H, device="cpu"))):
        state = torch.load(port / f"{name}-best.pt", weights_only=True)
        make.load_state_dict(state)
        template = bridge.params_to_numpy(make)
        want = load_pytree(str(jax_dir / f"{name}-best.msgpack"), template)
        _same_tree(bridge.params_to_numpy(make), want)


@pytest.mark.parametrize("name", ["fc", "topdown", "adaatt", "stackcap"])
def test_migrated_family_evaluates_as_jax(name, tmp_path, monkeypatch):
    """A generated reference checkpoint of the family through the port's
    `migrate_reference` and `cli.eval_paired --device cpu`: the predictions
    of JAX's `eval_split` on JAX's conversion of the same `.pth`, at beam
    2, and the same XE loss within 1e-5."""
    from unpaired_image_captioning_tpu import models as jmodels
    from unpaired_image_captioning_tpu.config import Config
    from unpaired_image_captioning_tpu.data.dataloader import (
        CaptionDataLoader as JLoader)
    from unpaired_image_captioning_tpu.eval import eval_utils as jeval
    from unpaired_image_captioning_tpu.models import convert as jconv
    import h5py

    from unpaired_image_captioning_tpu_torch.cli import eval_paired
    from unpaired_image_captioning_tpu_torch.data import synthetic as tsyn
    from unpaired_image_captioning_tpu_torch.data.arrays import read_arrays

    monkeypatch.chdir(tmp_path)
    make, kw = REFS[name]
    state = _sharpen(make(6), name)
    pth = tmp_path / "model_i2t-best.pth"
    torch.save({k: torch.from_numpy(v) for k, v in state.items()}, pth)
    cfg = dict(CAP_CFG, caption_model=name, **FAMILY_CFG.get(name, {}))
    opt = argparse.Namespace(seq_per_img=2, **{
        k: v for k, v in cfg.items() if k != "drop_prob_lm"})
    with open(tmp_path / "infos-best.pkl", "wb") as f:
        pickle.dump({"opt": opt, "iter": 9, "epoch": 1}, f, protocol=2)
    jpath, label, mem = tsyn.make_caption_artifacts(
        str(tmp_path), vocab_size=V1 - 1, seq_length=7, caps_per_img=2,
        fc_dim=FC, att_dim=ATT, seed=4, n_test=3)
    fc_dir, att_dir = tsyn.write_feature_dirs(str(tmp_path), mem)
    h5 = str(tmp_path / "label.h5")      # the JAX loader reads HDF5
    with h5py.File(h5, "w") as f:
        for k, v in read_arrays(label).items():
            f[k] = v
    run = tmp_path / "migrated"
    migrate_reference.main(["--out_dir", str(run), "--caption_model", name,
                            "--i2t_pth", str(pth), "--infos_pkl",
                            str(tmp_path / "infos-best.pkl")])
    data = dict(input_json=jpath, input_label_h5=label, input_fc_dir=fc_dir,
                input_att_dir=att_dir, batch_size=3, seq_per_img=2)
    argv = dict(data, start_from=str(run), beam_size=2, id="mig",
                device="cpu")
    got = eval_paired.main([x for k, v in argv.items()
                            for x in ("--" + k, str(v))])
    jm = jmodels.setup(Config(**cfg))
    loader = JLoader(**dict(data, input_label_h5=h5), att_feat_size=ATT,
                     attri_feat_size=16)
    want = jeval.eval_split(jm, jconv.CONVERTERS[name](state, **kw), loader,
                            split="test", beam_size=2, model_id="mig_jax")
    assert got["predictions"] == want["predictions"]
    assert len(got["predictions"]) == 3
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5,
                               atol=1e-5)
