"""`Trainer.profile` (the counterpart of the JAX `Trainer.profile`, on
`torch.profiler`) on the CPU at tiny widths: it returns the JAX method's
four keys, writes a Chrome trace that names the step's operations, and
its steps are the trainer's own `train` steps: the parameters, the Adam
state and the generator after `profile(n)` equal those after `n` plain
steps from the same state (dropout on, so the generator's draws count).
"""

import json
import os

import numpy as np
import pytest
import torch

from unpaired_image_captioning_tpu_torch.config import Config
from unpaired_image_captioning_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)
B, N, T, V = 3, 5, 4, 17
CFG = dict(caption_model="denseatt", vocab_size=V, input_encoding_size=16,
           rnn_size=16, num_layers=1, fc_feat_size=12, att_feat_size=12,
           att_hid_size=8, seq_length=T, batch_size=B, seq_per_img=1,
           i2t_train_flag=True, drop_prob_lm=0.5, seed=3)


def _batches(n):
    rs = np.random.RandomState(0)
    out = []
    for _ in range(n):
        labels = np.zeros((B, T + 2), np.int64)
        labels[:, 1:T + 1] = rs.randint(1, V + 1, (B, T))
        masks = np.ones((B, T + 2), np.float32)
        out.append({"fc_feats": rs.randn(B, 12).astype(np.float32),
                    "att_feats": rs.randn(B, N, 12).astype(np.float32),
                    "att_masks": np.ones((B, N), np.float32),
                    "labels": labels, "masks": masks})
    return out


def _state(trainer):
    out = dict(trainer.i2t_model.state_dict())
    st = trainer.optim.state_dict()["i2t_state"]
    for i, part in enumerate(st):
        for field, v in part.items():
            for k, x in (v.items() if isinstance(v, dict) else [("", v)]):
                out[f"opt.{i}.{field}.{k}"] = x
    out["generator"] = trainer.generator.get_state()
    return out


@pytest.mark.parametrize("n_steps", [1, 3])
def test_profile_steps_are_train_steps(n_steps, tmp_path):
    cfg = dict(CFG, checkpoint_path=str(tmp_path / "run"))
    profiled = Trainer(Config(**cfg), device="cpu")
    plain = Trainer(Config(**cfg), device="cpu")
    batches = _batches(n_steps + 1)
    res = profiled.profile(iter(batches), n_steps=n_steps)
    for b in batches[:n_steps]:
        plain.train(b)
    assert set(res) == {"trace_dir", "steps", "mean_step_s", "min_step_s"}
    assert res["steps"] == n_steps
    assert res["trace_dir"] == os.path.join(cfg["checkpoint_path"], "trace")
    assert 0 < res["min_step_s"] <= res["mean_step_s"]
    assert profiled.iteration == plain.iteration == n_steps
    got, want = _state(profiled), _state(plain)
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], torch.Tensor):
            assert torch.equal(got[k], want[k]), k
        else:
            assert got[k] == want[k], k
    # the step moved the parameters
    fresh = Trainer(Config(**cfg), device="cpu").i2t_model.state_dict()
    assert not all(torch.equal(fresh[k], got[k]) for k in fresh)


def test_profile_writes_a_chrome_trace(tmp_path):
    trainer = Trainer(Config(**CFG, checkpoint_path=str(tmp_path / "run")),
                      device="cpu")
    log_dir = str(tmp_path / "elsewhere")
    res = trainer.profile(iter(_batches(2)), n_steps=2, log_dir=log_dir)
    assert res["trace_dir"] == log_dir
    assert not os.path.exists(tmp_path / "run" / "trace")
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    # the forward's products and the backward's
    assert "aten::mm" in names or "aten::addmm" in names
    assert any("Backward" in n for n in names)
