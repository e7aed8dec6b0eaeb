"""The ensemble and the weight surgery in the port (`models/ensemble.py`,
`ops/beam_search._expand_to_beams`' ensemble branch, `cli/eval_ensemble.py`,
`models/weight_init.py`) against the JAX package on the CPU:

- an fc + TopDown `AttEnsemble` on bridged parameters (V 31, H = E 32, 6
  att slots, two images padded): beam-3 tokens identical and scores within
  1e-4, greedy tokens identical; the members' ctxs expand to the beams by
  their own no_expand (TopDown's memory stays per image, fc's None stays
  None);
- `cli.eval_ensemble --device cpu` over two run dirs gives the ensemble's
  own beam decode of the test split;
- `transplant` (with a rename across architectures, and strict) and
  `partial_embedding_transplant` against JAX's on the same trees.
"""

import json

import numpy as np
import pytest
import torch

from unpaired_image_captioning_tpu_torch import bridge
from unpaired_image_captioning_tpu_torch import models as tmodels
from unpaired_image_captioning_tpu_torch.config import Config as TConfig
from unpaired_image_captioning_tpu_torch.models import weight_init as twi
from unpaired_image_captioning_tpu_torch.models.base import Features
from unpaired_image_captioning_tpu_torch.models.ensemble import AttEnsemble
from unpaired_image_captioning_tpu_torch.ops import beam_search as tbs

torch.set_num_threads(1)
B, N, V, T = 4, 6, 31, 8
KW = dict(vocab_size=V, rnn_size=32, input_encoding_size=32,
          att_hid_size=16, fc_feat_size=24, att_feat_size=20, seq_length=T,
          num_layers=1, drop_prob_lm=0.0)


@pytest.fixture(scope="module")
def members():
    import jax
    import jax.numpy as jnp

    from unpaired_image_captioning_tpu import models as jmodels
    from unpaired_image_captioning_tpu.config import Config
    from unpaired_image_captioning_tpu.models.base import Features as JF

    jms, jps, tms = [], [], []
    for i, name in enumerate(("fc", "topdown")):
        cfg = dict(KW, caption_model=name)
        jm = jmodels.setup(Config(**cfg))
        jp = jm.init_params(jax.random.PRNGKey(10 + i))
        # sharper members: the two disagree, so the mixture is not either
        jp["logit"] = jax.tree.map(lambda x: x * 8.0, jp["logit"])
        tm = tmodels.setup(TConfig(**cfg), device="cpu")
        tm.load_state_dict(bridge.params_from_jax(jp))
        jms.append(jm)
        jps.append(jp)
        tms.append(tm)
    rs = np.random.RandomState(0)
    fc = rs.randn(B, 24).astype(np.float32)
    att = rs.randn(B, N, 20).astype(np.float32)
    masks = np.ones((B, N), np.float32)
    masks[1, 4:] = 0.0
    masks[3, 2:] = 0.0
    jf = JF(jnp.asarray(fc), jnp.asarray(att), None, jnp.asarray(masks))
    tf = Features(torch.from_numpy(fc), torch.from_numpy(att), None,
                  torch.from_numpy(masks))
    return jms, jps, tms, jf, tf


def test_ensemble_beam_and_greedy_match_jax(members):
    import jax

    from unpaired_image_captioning_tpu.models.ensemble import (
        AttEnsemble as JEns)

    jms, jps, tms, jf, tf = members
    jens, tens = JEns(tuple(jms)), AttEnsemble(tms)
    jr = jax.jit(lambda p, f: jens.sample_beam(p, f, beam_size=3))(
        tuple(jps), jf)
    tr = tens.sample_beam(tf, beam_size=3)
    np.testing.assert_array_equal(tr.seq.numpy(), np.asarray(jr.seq))
    np.testing.assert_allclose(tr.scores.numpy(), np.asarray(jr.scores),
                               atol=1e-4)
    js, _ = jax.jit(lambda p, f: jens.sample(p, f, jax.random.PRNGKey(0)))(
        tuple(jps), jf)
    ts, _ = tens.sample(tf)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # the mixture is neither member's decode
    solo = [m.sample_beam(tf, beam_size=3).seq for m in tms]
    assert not all(torch.equal(s, tr.seq) for s in solo)


def test_member_ctxs_expand_by_their_own_keys(members):
    _, _, tms, _, tf = members
    ens = AttEnsemble(tms)
    ctxs, _ = ens.make_decoder(tf)
    assert ctxs[0] is None
    no_expand = tuple(m.beam_ctx_no_expand for m in tms)
    out = tbs._expand_to_beams(ctxs, 3, no_expand=no_expand)
    assert out[0] is None
    assert out[1]["att"].shape[0] == B            # shared by the beams
    assert out[1]["fc"].shape[0] == B * 3


def _run_dir(path, model, cfg, files):
    from unpaired_image_captioning_tpu_torch.train.checkpoint import (
        CheckpointManager, save_json)

    opt = dict(cfg, **files, batch_size=2, seq_per_img=2)
    CheckpointManager(str(path)).save(i2t_state=model.state_dict(),
                                      best=True)
    save_json(str(path / "infos-best.json"),
              {"opt": TConfig(**opt).to_dict(), "iter": 1, "epoch": 0})


def test_eval_ensemble_cli(members, tmp_path, monkeypatch):
    from unpaired_image_captioning_tpu_torch.cli import eval_ensemble
    from unpaired_image_captioning_tpu_torch.data import synthetic as tsyn
    from unpaired_image_captioning_tpu_torch.data.dataloader import (
        CaptionDataLoader)

    _, _, tms, _, _ = members
    monkeypatch.chdir(tmp_path)
    jpath, label, mem = tsyn.make_caption_artifacts(
        str(tmp_path), vocab_size=V, seq_length=T, caps_per_img=2,
        fc_dim=24, att_dim=20, seed=2, n_test=3)
    fc_dir, att_dir = tsyn.write_feature_dirs(str(tmp_path), mem)
    files = dict(input_json=jpath, input_label_h5=label, input_fc_dir=fc_dir,
                 input_att_dir=att_dir)
    runs = []
    for name, m in zip(("fc", "topdown"), tms):
        runs.append(tmp_path / name)
        _run_dir(runs[-1], m, dict(KW, caption_model=name), files)
    out = eval_ensemble.main(["--ids", *map(str, runs), "--batch_size", "2",
                              "--beam_size", "3", "--language_eval", "1",
                              "--device", "cpu"])
    # the test split's three images, read as the CLI reads them (two a
    # batch, the first caption row of each), decoded in one batch
    loader = CaptionDataLoader(**files, batch_size=2, seq_per_img=2,
                               att_feat_size=20)
    loader.reset_iterator("test")
    rows, ids = {k: [] for k in ("fc_feats", "att_feats", "att_masks")}, []
    while len(ids) < 3:
        data = loader.get_batch("test")
        for j, info in enumerate(data["infos"]):
            if info["id"] not in ids and len(ids) < 3:
                ids.append(info["id"])
                for k in rows:
                    rows[k].append(data[k][2 * j])
    feats = Features(fc_feats=torch.from_numpy(np.stack(rows["fc_feats"])),
                     att_feats=torch.from_numpy(np.stack(rows["att_feats"])),
                     att_masks=torch.from_numpy(np.stack(rows["att_masks"])))
    want = AttEnsemble(tms).sample_beam(feats, beam_size=3).seq[:, 0]
    assert [p["image_id"] for p in out["predictions"]] == ids
    assert [p["caption"] for p in out["predictions"]] == [
        loader.vocab.decode_sequence(want[i:i + 1].numpy())[0]
        for i in range(3)]
    assert np.isfinite(out["overall"]["CIDEr"])
    with open(tmp_path / "eval_results" / "ensemble_test.json") as f:
        assert json.load(f)["predictions"] == out["predictions"]


@pytest.mark.parametrize("strict", [False, True])
def test_transplant_matches_jax(strict):
    import jax

    from unpaired_image_captioning_tpu import models as jmodels
    from unpaired_image_captioning_tpu.config import Config
    from unpaired_image_captioning_tpu.models import weight_init as jwi

    # a StackAtt donor into a TopDown: lstm0 -> att_lstm where the shapes
    # agree (they do not: 2H + E vs E + H inputs), embeddings, logit
    cfgs = {k: dict(KW, caption_model=k) for k in ("stackatt", "topdown")}
    donor = jmodels.setup(Config(**cfgs["stackatt"])).init_params(
        jax.random.PRNGKey(1))
    fresh = jmodels.setup(Config(**cfgs["topdown"])).init_params(
        jax.random.PRNGKey(2))
    rename_j = {"/core/att1": "/core/attention"}
    rename_t = {"core.att1": "core.attention"}
    t_fresh = bridge.params_from_jax(fresh)
    t_donor = bridge.params_from_jax(donor)
    if strict:
        # a path in both with another shape raises in both
        with pytest.raises(ValueError, match="shape mismatch"):
            jwi.transplant(fresh, {**donor, "ctx2att": {
                "w": np.zeros((3, 3), np.float32), "b": donor["ctx2att"]["b"]}},
                strict=True)
        with pytest.raises(ValueError, match="shape mismatch"):
            twi.transplant(t_fresh, {**t_donor,
                                     "ctx2att.w": torch.zeros(3, 3)},
                           strict=True)
        return
    jp, jt, js = jwi.transplant(fresh, donor, rename=rename_j)
    tp, tt, ts = twi.transplant(t_fresh, t_donor, rename=rename_t)

    def dots(paths):
        return sorted(p.strip("/").replace("/", ".") for p in paths)

    assert sorted(tt) == dots(jt) and sorted(ts) == dots(js)
    assert "core.attention.h2att.w" in tt and "core.att_lstm.w" in ts
    want = bridge.params_from_jax(jp)
    assert set(tp) == set(want)
    for k in want:
        assert torch.equal(tp[k], want[k]), k
    model = tmodels.setup(TConfig(**cfgs["topdown"]), device="cpu")
    model.load_state_dict(tp)


def test_partial_embedding_transplant_matches_jax():
    import jax.numpy as jnp

    from unpaired_image_captioning_tpu.models import weight_init as jwi

    rs = np.random.RandomState(0)
    fresh = rs.randn(7, 4).astype(np.float32)
    donor = rs.randn(5, 4).astype(np.float32)
    row_map = np.array([[0, 4], [3, 1], [6, 0]])
    want = jwi.partial_embedding_transplant(jnp.asarray(fresh), donor,
                                            row_map)
    t_fresh = torch.from_numpy(fresh.copy())
    got = twi.partial_embedding_transplant(t_fresh, torch.from_numpy(donor),
                                           row_map)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(t_fresh, torch.from_numpy(fresh))   # left alone
