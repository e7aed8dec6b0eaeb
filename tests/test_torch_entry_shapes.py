"""The denseatt captioner at the full shapes of `__graft_entry__.entry()`
(vocab 9,487, rnn / input encoding / attention hidden 512, fc and att
features 2,048, batch 16, 36 attention slots, 16 + 2 label columns): the
JAX package's `fn` on its own parameters and inputs, and the port's
denseatt on the same parameters (`bridge.params_from_jax`) and inputs. The
teacher-forced XE logprobs agree within atol 1e-5, the tolerance of the
small-width check (`tests/test_torch_captioner.py`)."""

import numpy as np
import torch

from unpaired_image_captioning_tpu_torch import bridge
from unpaired_image_captioning_tpu_torch import models as tmodels
from unpaired_image_captioning_tpu_torch.config import Config
from unpaired_image_captioning_tpu_torch.models.base import Features

TOL = 1e-5


def test_entry_logprobs_match_jax():
    import __graft_entry__

    fn, (params, feats, seq) = __graft_entry__.entry()
    want = np.asarray(fn(params, feats, seq))
    cfg = Config(caption_model="denseatt", vocab_size=9487, rnn_size=512,
                 num_layers=1, input_encoding_size=512, att_hid_size=512,
                 fc_feat_size=2048, att_feat_size=2048, seq_length=16,
                 drop_prob_lm=0.5, batch_size=16)
    model = tmodels.setup(cfg, device="cpu")
    model.load_state_dict(bridge.params_from_jax(params))
    model.eval()
    tf = Features(fc_feats=torch.from_numpy(np.array(feats.fc_feats)),
                  att_feats=torch.from_numpy(np.array(feats.att_feats)),
                  att_masks=torch.from_numpy(np.array(feats.att_masks)))
    with torch.no_grad():
        got = model.forward(tf, torch.from_numpy(np.array(seq)).long())
    assert got.shape == want.shape == (16, 17, 9488)
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
