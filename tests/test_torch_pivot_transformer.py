"""PyTorch port, the transformer pivot end to end at tiny widths: a
transformer captioner (beam) -> transformer NMT (beam) through
`pivot_translate` (zh, en and aux identical to the JAX package), and the
port's `PivotService` and HTTP `POST /pivot` against the JAX
`PivotService` on the same requests (identical strings)."""

import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from unpaired_image_captioning_tpu import constants as C
from unpaired_image_captioning_tpu import models as jmodels
from unpaired_image_captioning_tpu import pivot as jpivot
from unpaired_image_captioning_tpu.config import Config
from unpaired_image_captioning_tpu.models.base import Features as JFeatures
from unpaired_image_captioning_tpu.models.nmt_transformer import (
    TransformerNMTModel as JTNMT)
from unpaired_image_captioning_tpu.serve import PivotService as JPivotService
from unpaired_image_captioning_tpu.vocab import CaptionVocab, make_nmt_dict
from unpaired_image_captioning_tpu_torch import bridge
from unpaired_image_captioning_tpu_torch import models as tmodels
from unpaired_image_captioning_tpu_torch import pivot as tpivot
from unpaired_image_captioning_tpu_torch.models.base import Features
from unpaired_image_captioning_tpu_torch.models.nmt_transformer import (
    TransformerNMTModel)
from unpaired_image_captioning_tpu_torch.serve import (CaptionService,
                                                       PivotService,
                                                       make_http_server)

torch.set_num_threads(1)

CFG = Config(**{**vars(__graft_entry__._tiny_cfg()),
                "caption_model": "transformer", "num_layers": 2,
                "num_heads": 4})
NMT_KW = dict(src_vocab_size=CFG.nmt_src_vocab_size,
              tgt_vocab_size=CFG.nmt_tgt_vocab_size, d_model=16, d_ff=32,
              num_layers=2, num_heads=4)
B, N = 4, 5
CAP_BEAM, NMT_BEAM, NMT_MAX_LEN = 3, 5, 8


@pytest.fixture(scope="module")
def setup():
    cap_vocab = CaptionVocab({str(i): f"w{i}"
                              for i in range(1, CFG.vocab_size + 1)})
    nmt_src = make_nmt_dict()
    for i in range(1, CFG.nmt_src_vocab_size - 3):    # w1..w28; w29+ are UNK
        nmt_src.add(f"w{i}")
    cap2nmt = tpivot.build_caption_to_nmt_map(cap_vocab, nmt_src)
    jcap = jmodels.setup(CFG)
    jcp = jcap.init_params(jax.random.PRNGKey(0))
    jnmt = JTNMT(**NMT_KW)
    jnp_ = jnmt.init_params(jax.random.PRNGKey(1))
    # lift the UNK logit so that translations mix UNK with other words and
    # the service's attention-argmax replacement runs; lower EOS a little so
    # that no translation ends at its first step
    gen = dict(jnp_["generator"])
    gen["b"] = gen["b"].at[C.UNK].set(1.0).at[C.EOS].set(-0.1)
    jnp_ = {**jnp_, "generator": gen}
    tcap = tmodels.setup(CFG, device="cpu")
    tcap.load_state_dict(bridge.params_from_jax(jcp))
    tnmt = TransformerNMTModel(**NMT_KW)
    tnmt.load_state_dict(bridge.params_from_jax(jnp_))
    rs = np.random.RandomState(5)
    fc = rs.randn(B, CFG.fc_feat_size).astype(np.float32)
    att = rs.randn(B, N, CFG.att_feat_size).astype(np.float32)
    return dict(cap_vocab=cap_vocab, cap2nmt=cap2nmt, jcap=jcap, jcp=jcp,
                jnmt=jnmt, jnp=jnp_, tcap=tcap, tnmt=tnmt, fc=fc, att=att)


def test_transformer_pivot_translate_matches_jax(setup):
    s = setup
    masks = np.ones((B, N), np.float32)
    masks[2, 3:] = 0.0

    @jax.jit
    def jrun(cp, np_, f):
        return jpivot.pivot_translate(s["jcap"], cp, s["jnmt"], np_, f,
                                      jnp.asarray(s["cap2nmt"]),
                                      cap_beam=CAP_BEAM, nmt_beam=NMT_BEAM,
                                      nmt_max_len=NMT_MAX_LEN)

    jf = JFeatures(fc_feats=jnp.asarray(s["fc"]),
                   att_feats=jnp.asarray(s["att"]),
                   att_masks=jnp.asarray(masks))
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
    assert (ten.numpy() == C.UNK).any()


def test_transformer_pivot_service_and_http_match_jax(setup):
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
        replaced = False
        for i in range(3):
            fc, att = s["fc"][i], s["att"][i]
            want = jsvc.pivot(fc, att)
            assert tsvc.pivot(fc, att) == want
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/pivot",
                data=json.dumps({"fc": fc.tolist(),
                                 "att": att.tolist()}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as r:
                assert json.loads(r.read()) == want
            assert want["zh"] and want["en"]
            # an UNK replaced by the attended zh word
            replaced |= any(w.startswith("w") for w in want["en"].split())
        assert replaced
        assert isinstance(csvc.caption(s["fc"][0], s["att"][0]), str)
    finally:
        server.shutdown()
        server.server_close()
        st.join(10)
        for svc in (jsvc, tsvc, csvc):
            svc.close()
    assert not st.is_alive()
