"""The port's twin of the JAX package's quality guard
(`tests/test_joint_recipe.py::test_golden_scores_fixture`): the same
deterministic synthetic recipe (the fc captioner with the BiLSTM NMT,
Weight_Trans and Weight_Trans_y, XE then SCST from epoch 58 of 60, 121
steps) through the port's `cli.train` on the CPU, artifacts from the port's
copy of `data/synthetic.py`, then `eval_split` at beam 2 on the test split.

The fixture's scores come from JAX's own random streams over a test split
of two images, and the port's streams alone move them past the fixture's
bound of 0.05: the port's own run of the recipe (`PYTHONPATH=. python
tests/test_torch_golden.py --seed S --drop_prob_lm P` prints its scores)
reads CIDEr 0.218 at the recipe's seed 123 and 0.0 at seeds 1 and 2,
against the fixture's 0.308. So the two packages are held to each other
instead, on the recipe's argv with
every dropout 0 and both CLIs started from the JAX trainer's initial
parameters; the SCST steps' multinomial draws read one shared table of
uniform noise in both (each sampler's own Gumbel-max arithmetic on it).
The final parameters of both models agree within 1e-4, the losses of
every step within 1e-4 (relative past 1), and `eval_split`'s Bleu_4,
ROUGE_L and CIDEr on the final captioner within 1e-6 of JAX's; they also
sit within the fixture's bound of its scores. The fixture is read, never
written.
"""

import json
import os
import sys

import numpy as np
import torch

from unpaired_image_captioning_tpu_torch import constants as C
from unpaired_image_captioning_tpu_torch.data import synthetic as tsyn
from unpaired_image_captioning_tpu_torch.vocab import Dict

torch.set_num_threads(1)
ZH_V = 24
GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "recipe_scores.json")


def _mk_dict(labels_by_id):
    d = Dict([C.PAD_WORD, C.UNK_WORD, C.BOS_WORD, C.EOS_WORD])
    for i, lab in labels_by_id.items():
        d.idx_to_label[i] = lab
        d.label_to_idx[lab] = i
    return d


def _assets(tmp):
    """The JAX fixture's artifacts, written by the port's copy of the
    generator (labels and the corpus as .npz and, for the JAX CLI, .h5;
    features as one .npz an image)."""
    import h5py

    from unpaired_image_captioning_tpu_torch.data.arrays import read_arrays
    from unpaired_image_captioning_tpu_torch.scripts import prepro_ngrams

    jpath, label, mem = tsyn.make_caption_artifacts(
        str(tmp), vocab_size=ZH_V, seq_length=6, caps_per_img=2, seed=5)
    fc_dir, att_dir = str(tmp / "fc"), str(tmp / "att")
    os.makedirs(fc_dir), os.makedirs(att_dir)
    for i, v in mem["fc"].items():
        np.savez(os.path.join(fc_dir, f"{i}.npz"), feat=v)
    for i, v in mem["att"].items():
        np.savez(os.path.join(att_dir, f"{i}.npz"), feat=v)
    rng = np.random.RandomState(0)
    src = rng.randint(4, 4 + ZH_V, (96, 6)).astype(np.int32)
    tgt = np.zeros((96, 8), np.int32)
    tgt[:, 0] = C.BOS
    tgt[:, 1:7] = src + 8
    tgt[:, 7] = C.EOS
    nmt = str(tmp / "nmt.train.h5")
    with h5py.File(nmt, "w") as f:
        f["src"], f["tgt"] = src, tgt
    h5 = str(tmp / "label.h5")
    with h5py.File(h5, "w") as f:
        for k, v in read_arrays(label).items():
            f[k] = v
    dicts = str(tmp / "dicts.json")
    with open(dicts, "w") as f:
        json.dump({"src": _mk_dict({i + 4: f"w{i}" for i in range(ZH_V)})
                   .state_dict(),
                   "tgt": _mk_dict({j + 4: f"t{j}" for j in range(36)})
                   .state_dict()}, f)
    coco_json = str(tmp / "coco.json")
    with open(coco_json, "w") as f:
        json.dump({"ix_to_word": {str(i): f"t{i - 1}"
                                  for i in range(1, 20)}}, f)
    coco_wemb = str(tmp / "coco_wemb.npz")
    np.savez(coco_wemb, embedding=rng.randn(20, 16).astype(np.float32))
    ngrams = str(tmp / "ngrams.npz")
    prepro_ngrams.main(["--input_label_h5", label, "--input_json", jpath,
                        "--output", ngrams])
    return dict(input_json=jpath, input_label_h5=h5, input_fc_dir=fc_dir,
                input_att_dir=att_dir, input_nmt_h5=nmt,
                input_nmt_dict=dicts, input_coco_json=coco_json,
                input_coco_wemb=coco_wemb, cached_tokens=ngrams)


# the recipe's argv (tests/test_joint_recipe.py), every dropout 0
ARGS = dict(caption_model="fc", i2t_train_flag="true", nmt_train_flag="true",
            batch_size=4, seq_per_img=2, rnn_size=24, input_encoding_size=16,
            att_hid_size=12, fc_feat_size=32, att_feat_size=24, num_layers=1,
            word_vec_size=16, layers=1, drop_prob_lm=0, dropout=0,
            i2t_learning_rate=1e-2, nmt_optim="adam", nmt_learning_rate=5e-3,
            self_critical_after=58, max_epochs=60, losses_log_every=1,
            save_checkpoint_every=1000)
LOSS_KEYS = ("i2t_loss", "nmt_loss", "wemb_loss", "wemb_y_loss",
             "total_loss", "avg_reward")
TOL = 1e-4


def _shared_noise(monkeypatch):
    """Both samplers' multinomial draws read NOISE[t] (uniform on [1e-20,
    1), [T, rows, V + 1]) at step t of each decode."""
    import types

    import jax
    import jax.numpy as jnp

    from unpaired_image_captioning_tpu.ops import sampling as jsamp
    from unpaired_image_captioning_tpu_torch.models import base as tbase
    from unpaired_image_captioning_tpu_torch.ops import sampling as tsamp

    noise = np.random.RandomState(11).uniform(
        1e-20, 1.0, (6, 8, ZH_V + 1)).astype(np.float32)
    table = jnp.asarray(noise)
    monkeypatch.setattr(jsamp, "jax", types.SimpleNamespace(
        lax=jax.lax, random=types.SimpleNamespace(
            split=lambda rng, n: jnp.arange(n),
            uniform=lambda t, shape, minval, maxval: table[t])))
    step = [0]
    sample = tbase.sample_tokens

    def counted(*a, **kw):
        step[0] = 0
        return sample(*a, **kw)

    def draw(logprobs, generator, temperature=1.0):
        u = torch.from_numpy(noise[step[0]])
        step[0] += 1
        return torch.argmax(logprobs / temperature - torch.log(-torch.log(u)),
                            dim=-1)

    monkeypatch.setattr(tbase, "sample_tokens", counted)
    monkeypatch.setattr(tsamp, "gumbel_argmax", draw)


def test_fc_golden_recipe_matches_jax(tmp_path, monkeypatch,
                                      record_property):
    import jax

    from unpaired_image_captioning_tpu.cli import train as jcli
    from unpaired_image_captioning_tpu.data.dataloader import (
        CaptionDataLoader as JLoader)
    from unpaired_image_captioning_tpu.eval import eval_utils as jeval
    from unpaired_image_captioning_tpu.train import trainer as jtrainer
    from unpaired_image_captioning_tpu_torch import bridge
    from unpaired_image_captioning_tpu_torch.cli import train as tcli
    from unpaired_image_captioning_tpu_torch.data.dataloader import (
        CaptionDataLoader)
    from unpaired_image_captioning_tpu_torch.eval.eval_utils import (
        eval_split)
    from unpaired_image_captioning_tpu_torch.train import trainer as ttrainer

    # the metric loggers' optional TensorBoard import costs seconds
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    _shared_noise(monkeypatch)
    files = _assets(tmp_path)
    made = {}

    class JTrainer(jtrainer.Trainer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made["jax"] = self
            made["init"] = (jax.tree.map(np.asarray, self.i2t_params),
                            jax.tree.map(np.asarray, self.nmt_params))

    class TTrainer(ttrainer.Trainer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            i2t, nmt = made["init"]
            self.i2t_model.load_state_dict(bridge.params_from_jax(i2t))
            self.nmt_model.load_state_dict(bridge.params_from_jax(nmt))

    monkeypatch.setattr(jtrainer, "Trainer", JTrainer)
    monkeypatch.setattr(ttrainer, "Trainer", TTrainer)
    monkeypatch.chdir(tmp_path)

    def argv(run, **kw):
        args = dict(files, **ARGS, checkpoint_path=run,
                    id=os.path.basename(run), **kw)
        return [x for k, v in args.items() for x in ("--" + k, str(v))]

    jrun, trun = str(tmp_path / "jax_run"), str(tmp_path / "port_run")
    jcli.main(argv(jrun, dtype="float32"))
    got = tcli.main(argv(trun, device="cpu"))
    jt = made["jax"]
    assert got.iteration == jt.iteration == 121
    for model, params in ((got.i2t_model, jt.i2t_params),
                          (got.nmt_model, jt.nmt_params)):
        want = bridge.params_from_jax(jax.tree.map(np.asarray, params))
        have = model.state_dict()
        assert set(have) == set(want)
        for k in want:
            np.testing.assert_allclose(have[k].numpy(), want[k].numpy(),
                                       rtol=TOL, atol=TOL, err_msg=k)

    def steps(run):
        with open(os.path.join(run, "events.jsonl")) as f:
            return [e for e in map(json.loads, f) if "total_loss" in e]

    ev_t, ev_j = steps(trun), steps(jrun)
    assert len(ev_t) == len(ev_j) == 121
    assert sum("avg_reward" in e for e in ev_j) == 4
    for et, ej in zip(ev_t, ev_j):
        for k in LOSS_KEYS:
            assert (k in et) == (k in ej), (k, ej["step"])
            if k in ej:
                assert abs(et[k] - ej[k]) <= TOL * max(1.0, abs(ej[k])), (
                    k, et, ej)

    loader_kw = dict(input_json=files["input_json"],
                     input_label_h5=files["input_label_h5"],
                     input_fc_dir=files["input_fc_dir"],
                     input_att_dir=files["input_att_dir"], batch_size=4,
                     seq_per_img=2, att_feat_size=24, attri_feat_size=16)
    loader = CaptionDataLoader(**loader_kw)
    refs = loader.references("test")
    ours = eval_split(got.i2t_model, loader, split="test", beam_size=2,
                      language_eval_refs=refs, model_id="golden_port")
    theirs = jeval.eval_split(jt.i2t_model, jt.i2t_params,
                              JLoader(**loader_kw), split="test",
                              beam_size=2, language_eval_refs=refs,
                              model_id="golden_jax")
    assert ours["predictions"] == theirs["predictions"]
    for k in ("Bleu_4", "ROUGE_L", "CIDEr"):
        # the scores go to the JUnit report (--junitxml) as properties
        record_property(k, (ours["lang_stats"][k], theirs["lang_stats"][k]))
        assert abs(ours["lang_stats"][k] - theirs["lang_stats"][k]) < 1e-6, k
    with open(GOLDEN) as f:
        golden = json.load(f)
    for k in ("Bleu_4", "ROUGE_L", "CIDEr"):
        assert abs(ours["lang_stats"][k] - golden[k]) < 0.05, k


def _port_scores(tmp, seed: int, drop_prob_lm: float) -> dict:
    """The port's own run of the recipe (its initial parameters and random
    streams from `seed`) and its test split's scores at beam 2."""
    from unpaired_image_captioning_tpu_torch.cli import train as tcli
    from unpaired_image_captioning_tpu_torch.data.dataloader import (
        CaptionDataLoader)
    from unpaired_image_captioning_tpu_torch.eval.eval_utils import (
        eval_split)

    files = _assets(tmp)
    run = os.path.join(str(tmp), "run")
    # the recipe's argv: the NMT's dropout at its default
    recipe = {k: v for k, v in ARGS.items() if k != "dropout"}
    args = dict(files, **dict(recipe, drop_prob_lm=drop_prob_lm),
                checkpoint_path=run, id="run", seed=seed, device="cpu")
    tr = tcli.main([x for k, v in args.items() for x in ("--" + k, str(v))])
    tr.load()
    loader = CaptionDataLoader(
        input_json=files["input_json"],
        input_label_h5=files["input_label_h5"],
        input_fc_dir=files["input_fc_dir"],
        input_att_dir=files["input_att_dir"], batch_size=4, seq_per_img=2,
        att_feat_size=24, attri_feat_size=16)
    out = eval_split(tr.i2t_model, loader, split="test", beam_size=2,
                     language_eval_refs=loader.references("test"),
                     model_id="golden_port")
    return {k: out["lang_stats"][k] for k in ("Bleu_4", "ROUGE_L", "CIDEr")}


if __name__ == "__main__":
    import argparse
    import contextlib
    import io
    import pathlib
    import tempfile

    ap = argparse.ArgumentParser(description="The port's own scores on the "
                                 "golden recipe, on the CPU.")
    ap.add_argument("--seed", type=int, default=123)
    ap.add_argument("--drop_prob_lm", type=float, default=0.3)
    a = ap.parse_args()
    sys.modules["tensorflow"] = None
    with tempfile.TemporaryDirectory() as d:
        here = os.getcwd()
        os.chdir(d)
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                scores = _port_scores(pathlib.Path(d), a.seed,
                                      a.drop_prob_lm)
        finally:
            os.chdir(here)
    print(json.dumps({"seed": a.seed, "drop_prob_lm": a.drop_prob_lm,
                      **scores}))
