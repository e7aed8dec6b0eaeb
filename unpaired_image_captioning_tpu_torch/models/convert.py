"""Reference-checkpoint weight conversion (torch state_dict → param trees;
the port's copy of `unpaired_image_captioning_tpu/models/convert.py`, in
numpy only).

Lets a user of the reference load their trained `.pth` checkpoints into
this framework (the parity requirement of SURVEY.md §7.2 step 2:
token-identical greedy captions from converted reference weights).

Name/layout maps follow the reference module structures:
- `FCModel_NMT` (models/FCModel_NMT.py): `img_embed`, `embed`, `logit`,
  `core.i2h`/`core.h2h` (fused here into one [E+H, 5H] matrix; bias =
  i2h.bias + h2h.bias);
- `AttModel` family (models/AttModel.py): `embed.0`, `fc_embed.0`,
  `att_embed.<k>`, `ctx2att`, `logit`, plus per-core tensors — torch
  `nn.LSTMCell` uses gate order (i, f, g, o) vs this framework's
  (i, f, o, g), so rows are permuted;
- NMT (models/NMT_Models.py): bidirectional `nn.LSTM` weights per
  direction/layer (same gate permutation), StackedLSTM decoder cells,
  GlobalAttention linear_in/linear_out, embeddings, generator.

All inputs are numpy-valued state dicts (load with
`torch.load(..., map_location='cpu')` then `.numpy()` per tensor). The
output is the JAX package's parameter tree, with float32 numpy leaves:
`bridge.params_from_jax(tree)` is the state dict of the port's module.
The fork transformer's tree loads into `models/fork_transformer.py`
(`ForkTransformerNMT.from_fork_state_dict`).
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _t(state, name):
    return np.asarray(state[name])


def _f32(x):
    return np.asarray(x, np.float32)


def _linear(state, prefix):
    out = {"w": _f32(_t(state, prefix + ".weight").T)}
    if prefix + ".bias" in state:
        out["b"] = _f32(_t(state, prefix + ".bias"))
    else:
        out["b"] = np.zeros((out["w"].shape[1],), np.float32)
    return out


def _fused_cell_from_i2h_h2h(state, i2h, h2h):
    """Reference maxout-cell layout [3H sigmoid | 2H maxout] matches this
    framework directly — just fuse input and hidden blocks."""
    wi = _t(state, i2h + ".weight").T   # [E, 5H]
    wh = _t(state, h2h + ".weight").T   # [H, 5H]
    b = _t(state, i2h + ".bias") + _t(state, h2h + ".bias")
    return {"w": _f32(np.concatenate([wi, wh], axis=0)),
            "b": _f32(b)}


def _torch_lstmcell(state, prefix, *, ih="weight_ih", hh="weight_hh",
                    bih="bias_ih", bhh="bias_hh"):
    """torch LSTMCell/LSTM gates (i, f, g, o) -> this framework (i, f, o, g)."""
    def permute(w):  # w: [4H, in]
        h = w.shape[0] // 4
        i, f, g, o = w[:h], w[h:2 * h], w[2 * h:3 * h], w[3 * h:]
        return np.concatenate([i, f, o, g], axis=0)

    wi = permute(_t(state, f"{prefix}.{ih}")).T
    wh = permute(_t(state, f"{prefix}.{hh}")).T
    b = np.zeros((wi.shape[1],), np.float32)
    if f"{prefix}.{bih}" in state:
        b = permute(_t(state, f"{prefix}.{bih}")[:, None])[:, 0]
    if f"{prefix}.{bhh}" in state:
        b = b + permute(_t(state, f"{prefix}.{bhh}")[:, None])[:, 0]
    return {"w": _f32(np.concatenate([wi, wh], axis=0)),
            "b": _f32(b)}


def convert_fc_model(state: Dict[str, np.ndarray]) -> dict:
    """FCModel_NMT state_dict -> FCModel params."""
    return {
        "img_embed": _linear(state, "img_embed"),
        "embed": _f32(_t(state, "embed.weight")),
        "core": _fused_cell_from_i2h_h2h(state, "core.i2h", "core.h2h"),
        "logit": _linear(state, "logit"),
    }


def _attention(state, prefix="core.attention"):
    return {"h2att": _linear(state, prefix + ".h2att"),
            "alpha_net": _linear(state, prefix + ".alpha_net")}


def _bn(state, prefix):
    """torch BatchNorm1d state -> our _batch_norm params (incl. the trained
    running stats, so converted use_bn checkpoints evaluate correctly)."""
    return {"scale": _f32(_t(state, prefix + ".weight")),
            "offset": _f32(_t(state, prefix + ".bias")),
            "mean": _f32(_t(state, prefix + ".running_mean")),
            "var": _f32(_t(state, prefix + ".running_var"))}


def _att_embed_parts(state):
    """att_embed under the reference's use_bn layouts (AttModel.py:79-84):
    Sequential([BN,] Linear, ReLU, Dropout [, BN]) — the Linear shifts to
    index 1 when a leading BatchNorm is present; use_bn==2 adds a trailing
    BatchNorm at index 4."""
    if "att_embed.0.running_mean" in state:
        out = {"bn0": _bn(state, "att_embed.0"),
               "att_embed": _linear(state, "att_embed.1")}
        if "att_embed.4.running_mean" in state:
            out["bn1"] = _bn(state, "att_embed.4")
        return out
    return {"att_embed": _linear(state, "att_embed.0")}


def convert_topdown_model(state: Dict[str, np.ndarray]) -> dict:
    return {
        "embed": _f32(_t(state, "embed.0.weight")),
        "fc_embed": _linear(state, "fc_embed.0"),
        **_att_embed_parts(state),
        "ctx2att": _linear(state, "ctx2att"),
        "logit": [_linear(state, "logit")],
        "core": {
            "att_lstm": _torch_lstmcell(state, "core.att_lstm"),
            "lang_lstm": _torch_lstmcell(state, "core.lang_lstm"),
            "attention": _attention(state),
        },
    }


def convert_att2in2_model(state: Dict[str, np.ndarray]) -> dict:
    return {
        "embed": _f32(_t(state, "embed.0.weight")),
        "att_embed": _linear(state, "att_embed.0"),
        "ctx2att": _linear(state, "ctx2att"),
        "logit": [_linear(state, "logit")],
        "core": {
            "cell": _fused_cell_from_i2h_h2h(state, "core.i2h", "core.h2h"),
            "a2c": _linear(state, "core.a2c"),
            "attention": _attention(state),
        },
    }


def convert_att2all2_model(state: Dict[str, np.ndarray]) -> dict:
    """Att2all2Model: like att2in2 but the attention enters ALL 5H gates
    via a2h (AttModel.py:617-654, fc_embed deleted :678-684)."""
    return {
        "embed": _f32(_t(state, "embed.0.weight")),
        "att_embed": _linear(state, "att_embed.0"),
        "ctx2att": _linear(state, "ctx2att"),
        "logit": [_linear(state, "logit")],
        "core": {
            "cell": _fused_cell_from_i2h_h2h(state, "core.i2h", "core.h2h"),
            "a2h": _linear(state, "core.a2h"),
            "attention": _attention(state),
        },
    }


def convert_att2in_model(state: Dict[str, np.ndarray]) -> dict:
    """Original Att2inModel: bare embedding (no ReLU/dropout wrapper), raw
    att feats (att_embed identity), ctx2att and a2c from att_feat_size
    (AttModel.py:604-608, :707-722)."""
    return {
        "embed": _f32(_t(state, "embed.weight")),
        "ctx2att": _linear(state, "ctx2att"),
        "logit": [_linear(state, "logit")],
        "core": {
            "cell": _fused_cell_from_i2h_h2h(state, "core.i2h", "core.h2h"),
            "a2c": _linear(state, "core.a2c"),
            "attention": _attention(state),
        },
    }


def convert_adaatt_model(state: Dict[str, np.ndarray]) -> dict:
    """AdaAttModel / AdaAttMOModel: AdaAtt_lstm (w2h/v2h + per-layer
    i2h/h2h + the fake-region r_* heads, AttModel.py:256-341) and
    AdaAtt_attention (fr/ho sentinels + alpha_net + att2h, :344-406).
    The maxout variant only changes the gate width — same names."""
    n_layers = len({k.split(".")[2] for k in state
                    if k.startswith("core.lstm.h2h.")})
    core = {
        "w2h": _linear(state, "core.lstm.w2h"),
        "v2h": _linear(state, "core.lstm.v2h"),
        "h2h": [_linear(state, f"core.lstm.h2h.{i}")
                for i in range(n_layers)],
        "i2h": [_linear(state, f"core.lstm.i2h.{i}")
                for i in range(n_layers - 1)],
        "r_h2h": _linear(state, "core.lstm.r_h2h"),
        "fr_linear": _linear(state, "core.attention.fr_linear.0"),
        "fr_embed": _linear(state, "core.attention.fr_embed"),
        "ho_linear": _linear(state, "core.attention.ho_linear.0"),
        "ho_embed": _linear(state, "core.attention.ho_embed"),
        "alpha_net": _linear(state, "core.attention.alpha_net"),
        "att2h": _linear(state, "core.attention.att2h"),
    }
    if n_layers == 1:
        core["r_w2h"] = _linear(state, "core.lstm.r_w2h")
        core["r_v2h"] = _linear(state, "core.lstm.r_v2h")
    else:
        core["r_i2h"] = _linear(state, "core.lstm.r_i2h")
    return {
        "embed": _f32(_t(state, "embed.0.weight")),
        "fc_embed": _linear(state, "fc_embed.0"),
        **_att_embed_parts(state),
        "ctx2att": _linear(state, "ctx2att"),
        "logit": [_linear(state, "logit")],
        "core": core,
    }


def _torch_lstm_layers(state, prefix):
    """nn.LSTM weights (weight_ih_l{k}/weight_hh_l{k}, optional biases) ->
    our stacked-cell list (gate order permuted i,f,g,o -> i,f,o,g)."""
    cells = []
    k = 0
    while f"{prefix}.weight_ih_l{k}" in state:
        cells.append(_torch_lstmcell(
            state, prefix, ih=f"weight_ih_l{k}", hh=f"weight_hh_l{k}",
            bih=f"bias_ih_l{k}", bhh=f"bias_hh_l{k}"))
        k += 1
    return cells


def convert_show_tell_model(state: Dict[str, np.ndarray]) -> dict:
    """ShowTellModel (ShowTellModel.py:14-40): img_embed Linear, bare
    embedding, bias-free nn.LSTM core, logit."""
    return {
        "img_embed": _linear(state, "img_embed"),
        "embed": _f32(_t(state, "embed.weight")),
        "core": _torch_lstm_layers(state, "core"),
        "logit": _linear(state, "logit"),
    }


def convert_show_attend_tell_model(state: Dict[str, np.ndarray]) -> dict:
    """ShowAttendTellModel (OldModel.py:20-53, 182-252): `linear` maps fc
    to the initial hidden, bare embedding, bias-free nn.LSTM over
    [word; att_res], additive attention over RAW att feats whose ctx2att
    lives inside the core (mapped to our top-level slot — same math)."""
    return {
        "img_linear": _linear(state, "linear"),
        "embed": _f32(_t(state, "embed.weight")),
        "ctx2att": _linear(state, "core.ctx2att"),
        "logit": [_linear(state, "logit")],
        # fc_embed exists in our AttModel param tree but is unused by this
        # core (the reference maps fc only through `linear`); zero it
        "fc_embed": {"w": np.zeros((_t(state, "linear.weight").shape[1],
                                    _t(state, "logit.weight").shape[1]),
                                   np.float32),
                     "b": np.zeros((_t(state, "logit.weight").shape[1],),
                                   np.float32)},
        "core": {
            "lstm": _torch_lstm_layers(state, "core.rnn"),
            "attention": {"h2att": _linear(state, "core.h2att"),
                          "alpha_net": _linear(state, "core.alpha_net")},
        },
    }


def convert_all_img_model(state: Dict[str, np.ndarray]) -> dict:
    """AllImgModel (OldModel.py:232-256): `linear` initial hidden, bare
    embedding, bias-free nn.LSTM over [word; fc], logit."""
    return {
        "img_linear": _linear(state, "linear"),
        "embed": _f32(_t(state, "embed.weight")),
        "core": _torch_lstm_layers(state, "core.rnn"),
        "logit": _linear(state, "logit"),
    }


def convert_stack_dense_model(state: Dict[str, np.ndarray],
                              dense: bool = True) -> dict:
    core = {
        "lstm0": _fused_cell_from_i2h_h2h(state, "core.lstm0.i2h", "core.lstm0.h2h"),
        "lstm1": _fused_cell_from_i2h_h2h(state, "core.lstm1.i2h", "core.lstm1.h2h"),
        "lstm2": _fused_cell_from_i2h_h2h(state, "core.lstm2.i2h", "core.lstm2.h2h"),
        "att1": _attention(state, "core.att1"),
        "att2": _attention(state, "core.att2"),
        "emb2": _linear(state, "core.emb2"),
    }
    if dense:
        core["fusion1"] = _linear(state, "core.fusion1.0")
        core["fusion2"] = _linear(state, "core.fusion2.0")
    return {
        "embed": _f32(_t(state, "embed.0.weight")),
        "fc_embed": _linear(state, "fc_embed.0"),
        **_att_embed_parts(state),
        "ctx2att": _linear(state, "ctx2att"),
        "logit": [_linear(state, "logit")],
        "core": core,
    }


def convert_stackcap_model(state: Dict[str, np.ndarray]) -> dict:
    """Reference StackCapModel checkpoint -> our stackcap params.

    Layout (StackCapModel.py): AttModel embeddings (:56-77) plus the
    bias-free attri_embed (:62-64); StackCapCore (:256-293) with three
    maxout LSTMCores (i2h/h2h), att1/att2 additive attentions, and
    fusion1/fusion2 Sequential(Linear, ReLU, Dropout) heads — like
    DenseAtt's core but with NO emb2 and with attribute injection."""
    core = {
        "lstm0": _fused_cell_from_i2h_h2h(state, "core.lstm0.i2h",
                                          "core.lstm0.h2h"),
        "lstm1": _fused_cell_from_i2h_h2h(state, "core.lstm1.i2h",
                                          "core.lstm1.h2h"),
        "lstm2": _fused_cell_from_i2h_h2h(state, "core.lstm2.i2h",
                                          "core.lstm2.h2h"),
        "att1": _attention(state, "core.att1"),
        "att2": _attention(state, "core.att2"),
        "fusion1": _linear(state, "core.fusion1.0"),
        "fusion2": _linear(state, "core.fusion2.0"),
    }
    return {
        "embed": _f32(_t(state, "embed.0.weight")),
        "fc_embed": _linear(state, "fc_embed.0"),
        "attri_embed": {"w": _f32(
            _t(state, "attri_embed.0.weight").T)},
        **_att_embed_parts(state),
        "ctx2att": _linear(state, "ctx2att"),
        "logit": [_linear(state, "logit")],
        "core": core,
    }


def convert_transformer_model(state: Dict[str, np.ndarray], *,
                              num_layers: int) -> dict:
    """Reference TransformerModel checkpoint -> our transformer params.

    Layout (TransformerModel.py): att_embed Sequential(Linear,ReLU,Dropout)
    (:321-326, use_bn=0), model.{encoder,decoder}.layers.N with
    self_attn/src_attn MultiHeadedAttention `linears.{0..3}` = q/k/v/o
    (:287-300), feed_forward w_1/w_2 (:225-235), pre-norm sublayer norms
    a_2/b_2 (:96-105), final encoder/decoder norms, tgt_embed.0.lut
    (:238-245), generator.proj (:60-68)."""
    def ln(prefix):
        return {"scale": _f32(_t(state, prefix + ".a_2")),
                "offset": _f32(_t(state, prefix + ".b_2"))}

    def mha(prefix):
        return {k: _linear(state, f"{prefix}.linears.{i}")
                for i, k in enumerate(("q", "k", "v", "o"))}

    def ffn(prefix):
        return {"w1": _linear(state, prefix + ".w_1"),
                "w2": _linear(state, prefix + ".w_2")}

    p = {
        "att_embed": _linear(state, "att_embed.0"),
        "tgt_embed": _f32(_t(state, "model.tgt_embed.0.lut.weight")),
        "generator": _linear(state, "model.generator.proj"),
        "enc_norm": ln("model.encoder.norm"),
        "dec_norm": ln("model.decoder.norm"),
        "enc": [], "dec": [],
    }
    for i in range(num_layers):
        e = f"model.encoder.layers.{i}"
        p["enc"].append({"self": mha(e + ".self_attn"),
                         "ffn": ffn(e + ".feed_forward"),
                         "n1": ln(e + ".sublayer.0.norm"),
                         "n2": ln(e + ".sublayer.1.norm")})
        d = f"model.decoder.layers.{i}"
        p["dec"].append({"self": mha(d + ".self_attn"),
                         "src": mha(d + ".src_attn"),
                         "ffn": ffn(d + ".feed_forward"),
                         "n1": ln(d + ".sublayer.0.norm"),
                         "n2": ln(d + ".sublayer.1.norm"),
                         "n3": ln(d + ".sublayer.2.norm")})
    return p


def convert_fork_transformer(state: Dict[str, np.ndarray], *,
                             num_layers: int) -> dict:
    """OpenNMT-fork transformer checkpoint -> ForkTransformerNMT params.

    Layout (the fork's `-encoder_layer transformer -decoder_layer
    transformer` model, onmt/Models.py:197-200,324-327): `encoder.` /
    `decoder.` prefixes, per-layer `transformer.{i}` with
    `self_attn`/`context_attn` MultiHeadedAttention (biasless
    linear_{query,keys,values} + its own layer_norm, MultiHeadedAttn.py:
    19-25) and `feed_forward` (w_1/w_2 + its own layer_norm,
    Transformer.py:32-45); the decoder's unused GlobalAttention keys are
    ignored. Generator: external Sequential(Linear, LogSoftmax)."""
    def ln(prefix):
        return {"a_2": _f32(_t(state, prefix + ".a_2")),
                "b_2": _f32(_t(state, prefix + ".b_2"))}

    def mha(prefix):
        return {"q": {"w": _f32(
                    _t(state, prefix + ".linear_query.weight").T)},
                "k": {"w": _f32(
                    _t(state, prefix + ".linear_keys.weight").T)},
                "v": {"w": _f32(
                    _t(state, prefix + ".linear_values.weight").T)},
                "ln": ln(prefix + ".layer_norm")}

    def ffn(prefix):
        return {"w1": _linear(state, prefix + ".w_1"),
                "w2": _linear(state, prefix + ".w_2"),
                "ln": ln(prefix + ".layer_norm")}

    p = {"src_embed": _f32(
             _t(state, "encoder.embeddings.word_lut.weight")),
         "tgt_embed": _f32(
             _t(state, "decoder.embeddings.word_lut.weight")),
         "generator": _linear(state, "generator.0"),
         "enc": [], "dec": []}
    for i in range(num_layers):
        e = f"encoder.transformer.{i}"
        p["enc"].append({"self": mha(e + ".self_attn"),
                         "ffn": ffn(e + ".feed_forward")})
        d = f"decoder.transformer.{i}"
        p["dec"].append({"self": mha(d + ".self_attn"),
                         "src": mha(d + ".context_attn"),
                         "ffn": ffn(d + ".feed_forward")})
    return p


def convert_nmt_model(state: Dict[str, np.ndarray], *, layers: int = 1,
                      brnn: bool = True) -> dict:
    """Reference NMT (Encoder/Decoder/NMTModel + generator) -> NMTModel params."""
    p = {"encoder": {"embeddings": {"word_lut": _f32(
            _t(state, "encoder.embeddings.word_lut.weight"))},
         "layers": []},
         "decoder": {"embeddings": {"word_lut": _f32(
             _t(state, "decoder.embeddings.word_lut.weight"))},
             "rnn": [], "attn": {}},
         }
    if "encoder.embeddings.linear.weight" in state:
        # main-repo encoder embeddings MLP (NMT_Models.py:41-42,67 — the
        # py2 `feature_dicts=[]` default; see NMTEncoder.emb_mlp)
        p["encoder"]["embeddings"]["linear"] = _linear(
            state, "encoder.embeddings.linear")
    fluts = []
    while f"encoder.embeddings.feature_luts.{len(fluts)}.weight" in state:
        # `word￨feat` source-feature LUTs (fork Models.py:113-117)
        fluts.append(_f32(_t(
            state, f"encoder.embeddings.feature_luts.{len(fluts)}.weight")))
    if fluts:
        p["encoder"]["embeddings"]["feature_luts"] = fluts
    if "encoder.fertility_linear.weight" in state:
        # predicted-fertility head (fork Models.py:218-222)
        p["encoder"]["fertility_linear"] = _linear(
            state, "encoder.fertility_linear")
        p["encoder"]["fertility_linear_2"] = _linear(
            state, "encoder.fertility_linear_2")
        p["encoder"]["fertility_out"] = {"w": _f32(
            _t(state, "encoder.fertility_out.weight").T)}
    for l in range(layers):
        lp = {"fwd": _torch_lstmcell(state, "encoder.rnn",
                                     ih=f"weight_ih_l{l}", hh=f"weight_hh_l{l}",
                                     bih=f"bias_ih_l{l}", bhh=f"bias_hh_l{l}")}
        if brnn:
            lp["bwd"] = _torch_lstmcell(
                state, "encoder.rnn", ih=f"weight_ih_l{l}_reverse",
                hh=f"weight_hh_l{l}_reverse", bih=f"bias_ih_l{l}_reverse",
                bhh=f"bias_hh_l{l}_reverse")
        p["encoder"]["layers"].append(lp)
    for l in range(layers):
        p["decoder"]["rnn"].append(_torch_lstmcell(
            state, f"decoder.rnn.layers.{l}"))
    if "decoder.attn.linear_in.weight" in state:  # dotprod (Luong)
        p["decoder"]["attn"] = {
            "linear_in": {"w": _f32(_t(state, "decoder.attn.linear_in.weight").T)},
            "linear_out": {"w": _f32(_t(state, "decoder.attn.linear_out.weight").T)},
        }
    else:  # mlp (Bahdanau): GlobalAttention.__init__ :54-57
        p["decoder"]["attn"] = {
            "linear_context": {"w": _f32(
                _t(state, "decoder.attn.linear_context.weight").T)},
            "linear_query": {"w": _f32(
                _t(state, "decoder.attn.linear_query.weight").T)},
            "v": {"w": _f32(_t(state, "decoder.attn.v.weight").T)},
        }
    if "decoder.attn.linear_cover.weight" in state:
        # coverage projection (GlobalAttention.__init__ :76-77); dead at
        # reference runtime (no call site passes coverage) but present in
        # coverage-enabled checkpoints
        p["decoder"]["linear_cover"] = {"w": _f32(
            _t(state, "decoder.attn.linear_cover.weight").T)}
    if "decoder.context_gate.context_gate.gate.weight" in state:
        # Source/Target/BothContextGate all wrap one ContextGate module
        # (onmt/modules/Gate.py:25-45); the variant lives in config
        gp = "decoder.context_gate.context_gate"
        p["decoder"]["gate"] = {
            "gate": _linear(state, gp + ".gate"),
            "source_proj": _linear(state, gp + ".source_proj"),
            "target_proj": _linear(state, gp + ".target_proj"),
        }
    if "decoder.copy_attn.linear_in.weight" in state:
        # separate copy GlobalAttention, dotprod (fork Models.py:356-360)
        p["decoder"]["copy_attn"] = {
            "linear_in": {"w": _f32(
                _t(state, "decoder.copy_attn.linear_in.weight").T)},
            "linear_out": {"w": _f32(
                _t(state, "decoder.copy_attn.linear_out.weight").T)},
        }
    elif "decoder.copy_attn.linear_context.weight" in state:  # mlp variant
        p["decoder"]["copy_attn"] = {
            "linear_context": {"w": _f32(
                _t(state, "decoder.copy_attn.linear_context.weight").T)},
            "linear_query": {"w": _f32(
                _t(state, "decoder.copy_attn.linear_query.weight").T)},
            "v": {"w": _f32(
                _t(state, "decoder.copy_attn.v.weight").T)},
        }
    if "generator.0.weight" in state:
        p["generator"] = _linear(state, "generator.0")
    elif "generator.linear.weight" in state:
        # CopyGenerator (onmt/modules/CopyGenerator.py:17-18):
        # .linear is the vocab projection, .linear_copy the copy gate
        p["generator"] = _linear(state, "generator.linear")
        p["copy_gate"] = _linear(state, "generator.linear_copy")
    elif "generator.weight" in state:
        p["generator"] = _linear(state, "generator")
    return p


CONVERTERS = {
    "fc": convert_fc_model,
    "topdown": convert_topdown_model,
    "att2in2": convert_att2in2_model,
    "att2in": convert_att2in_model,
    "att2all2": convert_att2all2_model,
    "adaatt": convert_adaatt_model,
    "adaattmo": convert_adaatt_model,
    "show_tell": convert_show_tell_model,
    "show_attend_tell": convert_show_attend_tell_model,
    "all_img": convert_all_img_model,
    "stackatt": lambda s: convert_stack_dense_model(s, dense=False),
    "denseatt": lambda s: convert_stack_dense_model(s, dense=True),
    "stackcap": convert_stackcap_model,
    "transformer": lambda s, num_layers=6: convert_transformer_model(
        s, num_layers=num_layers),
}
