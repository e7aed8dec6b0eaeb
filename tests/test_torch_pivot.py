"""PyTorch port, the pivot serving path end to end at the tiny widths of
`__graft_entry__._tiny_cfg`: `pivot_translate` (zh, en and aux identical to
the JAX package), the port's `PivotService` and HTTP `POST /pivot` against
the JAX `PivotService` on the same requests (identical strings), and a
check that no module of the port imports jax."""

import ast
import json
import subprocess
import sys
import threading
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from unpaired_image_captioning_tpu import constants as C
from unpaired_image_captioning_tpu import models as jmodels
from unpaired_image_captioning_tpu import pivot as jpivot
from unpaired_image_captioning_tpu.models.base import Features as JFeatures
from unpaired_image_captioning_tpu.models.nmt import NMTModel as JNMTModel
from unpaired_image_captioning_tpu.serve import PivotService as JPivotService
from unpaired_image_captioning_tpu.vocab import CaptionVocab, make_nmt_dict
from unpaired_image_captioning_tpu_torch import bridge
from unpaired_image_captioning_tpu_torch import models as tmodels
from unpaired_image_captioning_tpu_torch import pivot as tpivot
from unpaired_image_captioning_tpu_torch.models.base import Features
from unpaired_image_captioning_tpu_torch.models.nmt import NMTModel
from unpaired_image_captioning_tpu_torch.serve import (CaptionService,
                                                       PivotService,
                                                       make_http_server)

torch.set_num_threads(1)

PORT_DIR = Path(__file__).resolve().parent.parent / "unpaired_image_captioning_tpu_torch"
CFG = __graft_entry__._tiny_cfg()
B, N = 4, 5
CAP_BEAM, NMT_BEAM, NMT_MAX_LEN = 3, 5, 8


def _vocabs():
    cap_vocab = CaptionVocab({str(i): f"w{i}" for i in range(1, CFG.vocab_size + 1)})
    nmt_src = make_nmt_dict()
    for i in range(1, CFG.nmt_src_vocab_size - 3):    # w1..w28; w29+ are UNK
        nmt_src.add(f"w{i}")
    return cap_vocab, nmt_src


@pytest.fixture(scope="module")
def setup():
    cap_vocab, nmt_src = _vocabs()
    cap2nmt = tpivot.build_caption_to_nmt_map(cap_vocab, nmt_src)
    jcap = jmodels.setup(CFG)
    jcp = jcap.init_params(jax.random.PRNGKey(0))
    jnmt = JNMTModel.from_config(CFG)
    jnp_ = jnmt.init_params(jax.random.PRNGKey(1))
    # lift the UNK logit just enough that translations mix UNK with other
    # words, so the service's attention-argmax replacement runs
    gen = dict(jnp_["generator"])
    gen["b"] = gen["b"].at[C.UNK].set(0.02)
    jnp_ = {**jnp_, "generator": gen}
    tcap = tmodels.setup(CFG, device="cpu")
    tcap.load_state_dict(bridge.params_from_jax(jcp))
    tnmt = NMTModel.from_config(CFG, device="cpu")
    tnmt.load_state_dict(bridge.params_from_jax(jnp_))
    rs = np.random.RandomState(5)
    fc = rs.randn(B, CFG.fc_feat_size).astype(np.float32)
    att = rs.randn(B, N, CFG.att_feat_size).astype(np.float32)
    return dict(cap_vocab=cap_vocab, nmt_src=nmt_src, cap2nmt=cap2nmt,
                jcap=jcap, jcp=jcp, jnmt=jnmt, jnp=jnp_, tcap=tcap,
                tnmt=tnmt, fc=fc, att=att)


def test_builders_match_jax(setup):
    s = setup
    np.testing.assert_array_equal(
        s["cap2nmt"], jpivot.build_caption_to_nmt_map(s["cap_vocab"],
                                                      s["nmt_src"]))
    for a, b in zip(tpivot.build_joint_vocab(s["cap_vocab"], s["nmt_src"]),
                    jpivot.build_joint_vocab(s["cap_vocab"], s["nmt_src"])):
        np.testing.assert_array_equal(a, b)
    seqs = np.array([[3, 30, 0, 0], [0, 0, 0, 0]], np.int32)
    for bos in (False, True):
        ts, tl = tpivot.captions_to_nmt_batch(
            torch.from_numpy(seqs).long(), torch.from_numpy(s["cap2nmt"]),
            add_bos_eos=bos)
        js, jl = jpivot.captions_to_nmt_batch(
            jnp.asarray(seqs), jnp.asarray(s["cap2nmt"]), add_bos_eos=bos)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


def test_pivot_translate_matches_jax(setup):
    s = setup
    masks = np.ones((B, N), np.float32)
    masks[2, 3:] = 0.0
    jf = JFeatures(fc_feats=jnp.asarray(s["fc"]), att_feats=jnp.asarray(s["att"]),
                   att_masks=jnp.asarray(masks))

    @jax.jit
    def jrun(cp, np_, f):
        return jpivot.pivot_translate(s["jcap"], cp, s["jnmt"], np_, f,
                                      jnp.asarray(s["cap2nmt"]),
                                      cap_beam=CAP_BEAM, nmt_beam=NMT_BEAM,
                                      nmt_max_len=NMT_MAX_LEN)

    jzh, jen, jaux = jrun(s["jcp"], s["jnp"], jf)
    tf = Features(fc_feats=torch.from_numpy(s["fc"]),
                  att_feats=torch.from_numpy(s["att"]),
                  att_masks=torch.from_numpy(masks))
    tzh, ten, taux = tpivot.pivot_translate(
        s["tcap"], s["tnmt"], tf, torch.from_numpy(s["cap2nmt"]),
        cap_beam=CAP_BEAM, nmt_beam=NMT_BEAM, nmt_max_len=NMT_MAX_LEN)
    np.testing.assert_array_equal(tzh.numpy(), np.asarray(jzh))
    np.testing.assert_array_equal(ten.numpy(), np.asarray(jen))
    np.testing.assert_array_equal(taux.numpy(), np.asarray(jaux))


def test_pivot_service_and_http_match_jax(setup):
    s = setup
    zh_vocab = dict(s["cap_vocab"].ix_to_word)
    tgt_itos = {i: f"en{i}" for i in range(CFG.nmt_tgt_vocab_size)}
    kw = dict(cap_beam=CAP_BEAM, nmt_beam=NMT_BEAM, nmt_max_len=NMT_MAX_LEN,
              max_batch=4, max_wait_ms=10)
    jsvc = JPivotService(s["jcap"], s["jcp"], s["jnmt"], s["jnp"], zh_vocab,
                         tgt_itos, s["cap2nmt"], **kw)
    tsvc = PivotService(s["tcap"], s["tnmt"], zh_vocab, tgt_itos,
                        s["cap2nmt"], **kw)
    csvc = CaptionService(s["tcap"], zh_vocab, beam_size=2, max_batch=4,
                          max_wait_ms=10)
    server = make_http_server(csvc, port=0, pivot_service=tsvc)
    port = server.server_address[1]
    st = threading.Thread(target=server.serve_forever, daemon=True)
    st.start()
    try:
        for i in range(3):
            fc, att = s["fc"][i], s["att"][i]
            want = jsvc.pivot(fc, att)
            got = tsvc.pivot(fc, att)
            assert got == want
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/pivot",
                data=json.dumps({"fc": fc.tolist(),
                                 "att": att.tolist()}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as r:
                assert json.loads(r.read()) == want
            # UNK replaced by the attended zh word, other words from itos
            assert want["zh"] and "w" in want["en"] and "en" in want["en"]
        assert isinstance(csvc.caption(s["fc"][0], s["att"][0]), str)
    finally:
        server.shutdown()
        server.server_close()
        st.join(10)
        for svc in (jsvc, tsvc, csvc):
            svc.close()
    assert not st.is_alive()


def test_copy_pivot_and_service_match_jax(setup):
    """`pivot_translate(..., src2tgt=)` with a copy-attention NMT (its copy
    gate raised so that exact copies are decoded): zh, the collapsed en and
    the aux with the copies' source positions identical to JAX's; the
    port's `PivotService(src2tgt=)` answers as the JAX one."""
    s = setup
    cfg = CFG.__class__(**{**vars(CFG), "copy_attn": True})
    jnmt = JNMTModel.from_config(cfg)
    jnp_ = jnmt.init_params(jax.random.PRNGKey(4))
    jnp_["copy_gate"] = {**jnp_["copy_gate"],
                         "b": jnp_["copy_gate"]["b"] + 2.0}
    tnmt = NMTModel.from_config(cfg, device="cpu")
    tnmt.load_state_dict(bridge.params_from_jax(jnp_))
    s2t = np.full((cfg.nmt_src_vocab_size,), C.PAD, np.int32)
    s2t[4:12] = np.arange(4, 12)                   # the rest copy exactly
    jf = JFeatures(fc_feats=jnp.asarray(s["fc"]),
                   att_feats=jnp.asarray(s["att"]))
    jzh, jen, jaux = jax.jit(lambda cp, np_, f: jpivot.pivot_translate(
        s["jcap"], cp, jnmt, np_, f, jnp.asarray(s["cap2nmt"]),
        cap_beam=CAP_BEAM, nmt_beam=NMT_BEAM, nmt_max_len=NMT_MAX_LEN,
        src2tgt=jnp.asarray(s2t)))(s["jcp"], jnp_, jf)
    tf = Features(fc_feats=torch.from_numpy(s["fc"]),
                  att_feats=torch.from_numpy(s["att"]))
    with torch.no_grad():
        tzh, ten, taux = tpivot.pivot_translate(
            s["tcap"], tnmt, tf, torch.from_numpy(s["cap2nmt"]),
            cap_beam=CAP_BEAM, nmt_beam=NMT_BEAM, nmt_max_len=NMT_MAX_LEN,
            src2tgt=s2t)
    np.testing.assert_array_equal(tzh.numpy(), np.asarray(jzh))
    np.testing.assert_array_equal(ten.numpy(), np.asarray(jen))
    np.testing.assert_array_equal(taux.numpy(), np.asarray(jaux))
    assert (ten == C.UNK).any()                    # copies came back as UNK
    zh_vocab = dict(s["cap_vocab"].ix_to_word)
    tgt_itos = {i: f"en{i}" for i in range(cfg.nmt_tgt_vocab_size)}
    kw = dict(cap_beam=CAP_BEAM, nmt_beam=NMT_BEAM, nmt_max_len=NMT_MAX_LEN,
              max_batch=4, max_wait_ms=10, src2tgt=s2t)
    jsvc = JPivotService(s["jcap"], s["jcp"], jnmt, jnp_, zh_vocab,
                         tgt_itos, s["cap2nmt"], **kw)
    tsvc = PivotService(s["tcap"], tnmt, zh_vocab, tgt_itos, s["cap2nmt"],
                        **kw)
    try:
        for i in range(2):
            assert tsvc.pivot(s["fc"][i], s["att"][i]) == jsvc.pivot(
                s["fc"][i], s["att"][i])
    finally:
        jsvc.close()
        tsvc.close()


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_never_imports_jax():
    files = sorted(PORT_DIR.rglob("*.py")) + [PORT_DIR.parent / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        for name in _imports(f):
            assert name.split(".")[0] != "jax", f"{f} imports {name}"
            assert not name.startswith("unpaired_image_captioning_tpu.ops"), name
            assert not name.startswith("unpaired_image_captioning_tpu.models"), name
    # and nothing they import pulls jax in transitively
    code = ("import sys, importlib, pkgutil, unpaired_image_captioning_tpu_torch as p\n"
            "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
            "    importlib.import_module(m.name)\n"
            "import chip_smoke\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=PORT_DIR.parent)
