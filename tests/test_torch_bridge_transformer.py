"""PyTorch port, bridge.py on the transformer parameter trees: the JAX
caption transformer's and transformer NMT's trees (the `enc` / `dec`
lists; `self`, `src`, `ffn`, `n1`-`n3`; `scale` / `offset`) load into the
port's modules key for key, with no missing or unexpected key, and
`params_to_numpy` gives the JAX tree back exactly."""

import jax
import numpy as np
import pytest

from unpaired_image_captioning_tpu import models as jmodels
from unpaired_image_captioning_tpu.config import Config
from unpaired_image_captioning_tpu.models.nmt_transformer import (
    TransformerNMTModel as JTNMT)
from unpaired_image_captioning_tpu_torch import bridge
from unpaired_image_captioning_tpu_torch import models as tmodels
from unpaired_image_captioning_tpu_torch.models.nmt_transformer import (
    TransformerNMTModel)

NMT_KW = dict(src_vocab_size=23, tgt_vocab_size=19, d_model=16, d_ff=24,
              num_layers=2, num_heads=4)


def _caption():
    cfg = Config(caption_model="transformer", vocab_size=17, rnn_size=24,
                 num_layers=2, input_encoding_size=16, fc_feat_size=8,
                 att_feat_size=12, seq_length=5, num_heads=4)
    return (jmodels.setup(cfg).init_params(jax.random.PRNGKey(0)),
            tmodels.setup(cfg, device="cpu"))


def _nmt(share):
    kw = dict(NMT_KW, share_decoder_embeddings=share)
    return (JTNMT(**kw).init_params(jax.random.PRNGKey(1)),
            TransformerNMTModel(**kw))


@pytest.mark.parametrize("make", [_caption, lambda: _nmt(False),
                                  lambda: _nmt(True)],
                         ids=["caption", "nmt", "nmt-shared-embeddings"])
def test_transformer_tree_round_trip(make):
    jp, module = make()
    result = module.load_state_dict(bridge.params_from_jax(jp), strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    keys = set(module.state_dict())
    assert {"dec.0.self.q.w", "dec.1.src.o.b", "dec.0.n3.scale",
            "enc.1.ffn.w2.w", "enc_norm.offset"} <= keys
    back = bridge.params_to_numpy(module)
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    flat_t = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_j] == [p for p, _ in flat_t]
    for (_, a), (_, b) in zip(flat_j, flat_t):
        np.testing.assert_array_equal(np.asarray(a), b)
