"""Scale-out in the port (`parallel/`, the trainer's `mesh=`) against the
JAX package on the CPU, at the dry run's tiny sizes (denseatt V 31, rnn
32, input encoding / attention hidden 16, fc 32, att 24 over 6 slots,
seq_length 8, global batch 8; the BiLSTM NMT at vocabularies 32, word
vectors 16, one layer), every dropout at 0 and Adam's eps at 1e-6.

- `param_sharding`'s placements against JAX `_tp_spec`'s PartitionSpecs
  leaf by leaf, on the captioner's and the NMT's trees, on a 2x2 mesh and
  a 1-D one; `shard_batch`'s blocks, with leading dims that do and do
  not divide; `make_mesh`'s count checks; the loader's striped `split_ix`
  against JAX's for `num_hosts` 1-3.
- Two steps on 2 gloo ranks ("2") and on 4 ("2x2", tensor parallel) of
  each scenario: XE on an even and an uneven global batch, the joint step
  (captioner XE, NMT NLL on an uneven batch, Weight_Trans, Weight_Trans_y,
  KLD), SCST (given samples, a real df table) and TopDown's use_bn 2,
  each against the JAX one-device `Trainer` on the same global batch:
  every metric and every parameter within 1e-5. The global-norm clip is
  active (max norm 0.1). Under 2x2 each rank holds half of every
  model-sharded leaf.
- The 2x2 checkpoint loads into a one-device port `Trainer` bit for bit;
  `eval_split` on 2 ranks equals one device's; `dryrun_multichip(4,
  device="cpu")` passes.

The ranks start from a forkserver and join through a FileStore, so
concurrent test workers do not collide; each job is stopped after 120 s.
"""

import numpy as np
import pytest
import torch

from unpaired_image_captioning_tpu_torch import bridge
from unpaired_image_captioning_tpu_torch.config import Config as TConfig
from unpaired_image_captioning_tpu_torch.parallel import launch
from unpaired_image_captioning_tpu_torch.parallel import mesh as pmesh

torch.set_num_threads(1)
B, N, T, V, R = 8, 6, 8, 31, 3
SRC_V = TGT_V = 32
TOL = 1e-5
JOB_TIMEOUT = 120.0
CAP = dict(caption_model="denseatt", vocab_size=V, rnn_size=32,
           num_layers=1, input_encoding_size=16, att_hid_size=16,
           fc_feat_size=32, att_feat_size=24, seq_length=T, seq_per_img=1,
           batch_size=B, i2t_train_flag=True, drop_prob_lm=0.0,
           i2t_max_grad_norm=0.1, i2t_learning_rate=5e-4,
           i2t_optim_epsilon=1e-6, seed=7)
NMT = dict(nmt_train_flag=True, nmt_src_vocab_size=SRC_V,
           nmt_tgt_vocab_size=TGT_V, word_vec_size=16, layers=1, brnn=True,
           dropout=0.0, nmt_optim="adam", nmt_learning_rate=1e-3,
           nmt_optim_epsilon=1e-6, nmt_max_grad_norm=0.1)


def _cap_batch(b, seed=0):
    rs = np.random.RandomState(seed)
    labels = np.zeros((b, T + 2), np.int64)
    masks = np.zeros((b, T + 2), np.float32)
    for i in range(b):
        n = 1 + i % T
        labels[i, 1:1 + n] = rs.randint(1, V + 1, n)
        masks[i, :n + 2] = 1.0
    att_masks = np.ones((b, N), np.float32)
    att_masks[1, 4:] = 0.0
    att_masks[b - 1, 2:] = 0.0
    return {"fc_feats": rs.randn(b, 32).astype(np.float32),
            "att_feats": (rs.randn(b, N, 24) * 2 + 1).astype(np.float32),
            "att_masks": att_masks, "labels": labels, "masks": masks}


def _nmt_batch(b, seed=1):
    rs = np.random.RandomState(seed)
    s, t = 6, 7
    lengths = np.array([s - i % 4 for i in range(b)], np.int32)
    src = rs.randint(4, SRC_V, (b, s)).astype(np.int32)
    src[np.arange(s)[None, :] >= lengths[:, None]] = 0
    tgt = np.zeros((b, t), np.int32)
    for i in range(b):
        n = 1 + i % (t - 2)
        tgt[i, 0] = 2
        tgt[i, 1:1 + n] = rs.randint(4, TGT_V, n)
        tgt[i, 1 + n] = 3
    return {"src": src, "tgt": tgt, "lengths": lengths}


def _scst_inputs(seed=3):
    """gts [B, R, T + 2] with one masked reference, a df table of a corpus
    that holds them, and given (gen, greedy) samples [B, T]."""
    from unpaired_image_captioning_tpu_torch.scripts.prepro_ngrams import (
        compute_df)

    rs = np.random.RandomState(seed)
    rows = np.zeros(((B + 8) * R, T + 2), np.int64)
    for i in range(len(rows)):
        n = rs.randint(2, T + 3)
        rows[i, :n] = rs.randint(1, V + 1, n)
    start = np.arange(B + 8) * R + 1
    df, n_img = compute_df(rows, start, start + R - 1)
    gts = rows[:B * R].reshape(B, R, -1)
    mask = np.ones((B, R), np.float32)
    mask[1, 2] = 0.0
    gen = rs.randint(1, V + 1, (B, T)).astype(np.int64)
    for i in range(B):
        gen[i, :3] = gts[i, i % R, :3]
        gen[i, 3 + i % 5:] = 0
    head = gen[:, :3]
    head[head == 0] = 1
    greedy = rs.randint(1, V + 1, (B, T)).astype(np.int64)
    greedy[::2, 4:] = 0
    return gts, mask, df, float(n_img), gen, greedy


def _scenarios():
    """name -> (config dict, batch, trainer extras, SCST inputs or None)."""
    cap = _cap_batch(B)
    rs = np.random.RandomState(9)
    joint_extra = {"joint_vocab": (np.arange(1, 9), np.arange(4, 12)),
                   "joint_vocab_y": (rs.randn(15, 16).astype(np.float32)
                                     * 0.1, np.array([0, 4, 14]),
                                     np.array([4, 28, 7]))}
    gts, gmask, df, n_img, gen, greedy = _scst_inputs()
    return {
        "xe": (CAP, cap, {}, None),
        "xe_uneven": (CAP, _cap_batch(B - 1, seed=4), {}, None),
        "joint": (dict(CAP, **NMT, nmt_kld_train_flag=True),
                  dict(cap, nmt=_nmt_batch(B - 3)), joint_extra, None),
        "scst": (CAP, dict(cap, gts=gts, gts_masks=gmask), {},
                 (df, n_img, gen, greedy)),
        "bn": (dict(CAP, caption_model="topdown", use_bn=2),
               _cap_batch(B, seed=5), {}, None),
    }


def _port_extras(extra, cfg, teacher):
    out = dict(extra)
    if teacher is not None:
        out["nmt_teacher"] = {k: torch.from_numpy(v)
                              for k, v in teacher.items()}
    return out


def _mesh_worker(rank, world, mesh_shape, specs, ckpt_dir):
    """One rank: every scenario's two steps under the mesh. Rank 0 returns
    the metrics and the whole parameters; every rank returns the shapes of
    its sharded leaves. With `ckpt_dir`, the joint trainer saves there."""
    import torch.distributed as dist

    from unpaired_image_captioning_tpu_torch.ops import cider as tc
    from unpaired_image_captioning_tpu_torch.train.trainer import Trainer

    torch.set_num_threads(1)
    mesh = pmesh.make_mesh(world, mesh_shape)
    _, d_rank, d_size = pmesh.axis(mesh, "data")
    out = {}
    for name, (cfg, batch, extra, init, teacher, scst) in specs.items():
        kw = _port_extras(extra, cfg, teacher)
        if scst is not None:
            df, n_img, gen, greedy = scst
            kw["df_table"] = tc.build_df_table(df, n_img, device="cpu")
        # dtype f32 as on the JAX side (both defaults are "bfloat16")
        tr = Trainer(TConfig(**dict(cfg, checkpoint_path=ckpt_dir,
                                    dtype="float32")),
                     device="cpu", mesh=mesh, **kw)
        with tr.whole_params():
            for key, model in tr._models():
                if model is not None:
                    model.load_state_dict({k: torch.from_numpy(v) for k, v
                                           in init[key].items()})
        if scst is not None:
            lo, hi = pmesh.block_bounds(B, d_size, d_rank)

            def sample(feats, *, greedy=True, _g=greedy[lo:hi],
                       _s=gen[lo:hi], **_):
                return torch.from_numpy(_g if greedy else _s), None

            tr.i2t_model.sample = sample
        mine = pmesh.shard_batch(batch, mesh)
        metrics = [tr.train(mine, sc_flag=scst is not None)
                   for _ in range(2)]
        shapes = {f"{key}.{k}": tuple(s.params[k].shape)
                  for key, s in tr.shards.items() for k in s.dims}
        with tr.whole_params():
            params = {key: {k: v.numpy().copy()
                            for k, v in model.state_dict().items()}
                      for key, model in tr._models() if model is not None}
        if name == "joint" and ckpt_dir:
            tr.save()
        out[name] = (metrics, params if dist.get_rank() == 0 else None,
                     shapes)
    return out


def _eval_worker(rank, world, run_dir, artifacts, state):
    """`eval_split` of the val split on a 1-D mesh of `world` ranks."""
    from unpaired_image_captioning_tpu_torch.eval.eval_utils import (
        eval_split)

    torch.set_num_threads(1)
    mesh = pmesh.make_mesh(world, "data")
    model, loader = _eval_setup(artifacts, state)
    return eval_split(model, loader, split="val", beam_size=3,
                      eval_results_dir=run_dir, mesh=mesh)


def _eval_setup(artifacts, state):
    from unpaired_image_captioning_tpu_torch import models as tmodels
    from unpaired_image_captioning_tpu_torch.data.dataloader import (
        CaptionDataLoader)

    jpath, label, mem = artifacts
    loader = CaptionDataLoader(input_json=jpath, input_label_h5=label,
                               in_memory=mem, batch_size=5, seq_per_img=2,
                               att_feat_size=24)
    model = tmodels.setup(TConfig(**CAP), device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return model, loader


# ---------------------------------------------------------------------------
# references
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def scenarios(tmp_path_factory):
    """name -> (spec for the ranks, JAX metrics of 2 steps, JAX params)."""
    import jax
    import jax.numpy as jnp

    from unpaired_image_captioning_tpu.config import Config
    from unpaired_image_captioning_tpu.ops import cider as jc
    from unpaired_image_captioning_tpu.train.trainer import Trainer as JT

    out = {}
    tmp = str(tmp_path_factory.mktemp("jax"))
    for name, (cfg, batch, extra, scst) in _scenarios().items():
        jkw = dict(extra)
        teacher = None
        if name == "joint":
            from unpaired_image_captioning_tpu.models.nmt_transformer import (
                make_nmt_model)

            t_params = make_nmt_model(Config(**cfg)).init_params(
                jax.random.PRNGKey(11))
            jkw["nmt_teacher_params"] = t_params
            teacher = {k: v.numpy()
                       for k, v in bridge.params_from_jax(t_params).items()}
        if scst is not None:
            df, n_img, gen, greedy = scst
            jkw["df_table"] = jc.build_df_table(df, n_img)
        jt = JT(Config(**cfg, dtype="float32", checkpoint_path=tmp), **jkw)
        # the initial parameters, before the steps donate their buffers
        init = {key: {k: v.numpy() for k, v in
                      bridge.params_from_jax(params).items()}
                for key, params in (("i2t", jt.i2t_params),
                                    ("nmt", jt.nmt_params))
                if params is not None}
        sample = type(jt.i2t_model).sample
        if scst is not None:
            def fixed(self, params, feats, rng, *, greedy=True, **_):
                return jnp.asarray(scst[3] if greedy else scst[2],
                                   jnp.int32), None

            type(jt.i2t_model).sample = fixed
        try:
            metrics = [jt.train(batch, sc_flag=scst is not None)
                       for _ in range(2)]
        finally:
            type(jt.i2t_model).sample = sample
        final = {}
        for key, params in (("i2t", jt.i2t_params), ("nmt", jt.nmt_params)):
            if params is not None and key in init:
                final[key] = {k: v.numpy() for k, v in
                              bridge.params_from_jax(params).items()}
        out[name] = ((cfg, batch, extra, init, teacher, scst), metrics,
                     final)
    return out


def _specs(scenarios):
    return {k: v[0] for k, v in scenarios.items()}


@pytest.fixture(scope="module")
def two_rank(scenarios):
    return launch.run_ranks(_mesh_worker, 2,
                            ("2", _specs(scenarios), ""),
                            timeout=JOB_TIMEOUT)


@pytest.fixture(scope="module")
def four_rank(scenarios, tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("ckpt2x2"))
    return launch.run_ranks(_mesh_worker, 4,
                            ("2x2", _specs(scenarios), ckpt),
                            timeout=JOB_TIMEOUT), ckpt


def _held(result, name, scenarios):
    spec, want_metrics, want_params = scenarios[name]
    metrics, params, _ = result[0][name]
    for got, want in zip(metrics, want_metrics):
        assert set(got) == set(want), (set(got), set(want))
        for k, w in want.items():
            np.testing.assert_allclose(got[k], w, rtol=TOL, atol=TOL,
                                       err_msg=f"{name} {k}")
    for key, leaves in want_params.items():
        assert set(params[key]) == set(leaves)
        for k, w in leaves.items():
            np.testing.assert_allclose(params[key][k], w, rtol=TOL,
                                       atol=TOL, err_msg=f"{name} {key}.{k}")
    # every rank of a data block ends with the same metrics
    for other in result[1:]:
        assert other[name][0] == metrics


# ---------------------------------------------------------------------------
# placements, blocks, meshes, striping (no ranks)
# ---------------------------------------------------------------------------


class _FakeMesh:
    """The two attributes the placement rules read."""

    def __init__(self, shape, names):
        self.mesh_dim_names = names
        self._shape = shape

    def size(self, dim):
        return self._shape[dim]


def _jax_mesh(shape):
    import jax
    from jax.sharding import Mesh

    devs = np.asarray(jax.devices()[:int(np.prod(shape))]).reshape(shape)
    return Mesh(devs, ("data", "model")[:len(shape)])


@pytest.mark.parametrize("tree", ["i2t", "nmt"])
@pytest.mark.parametrize("shape", [(2, 2), (4,)], ids=["2x2", "4"])
def test_param_sharding_matches_jax_tp_spec(tree, shape):
    import jax
    from jax.sharding import PartitionSpec as P

    from unpaired_image_captioning_tpu import models as jmodels
    from unpaired_image_captioning_tpu.config import Config
    from unpaired_image_captioning_tpu.models.nmt_transformer import (
        make_nmt_model)
    from unpaired_image_captioning_tpu.parallel import mesh as jmesh

    cfg = Config(**CAP, **NMT)
    model = jmodels.setup(cfg) if tree == "i2t" else make_nmt_model(cfg)
    params = model.init_params(jax.random.PRNGKey(0))
    want = jmesh.param_sharding(params, _jax_mesh(shape),
                                tensor_parallel=True)
    names = ("data", "model")[:len(shape)]
    fake = _FakeMesh(shape, names)
    flat = bridge.params_from_jax(params)
    got = pmesh.param_sharding(flat, fake, tensor_parallel=True)
    got_tree = pmesh.param_sharding(
        jax.tree.map(np.asarray, params), fake, tensor_parallel=True)
    split = 0
    for path, sh in jax.tree_util.tree_leaves_with_path(want):
        key = ".".join(str(getattr(p, "key", getattr(p, "idx", None)))
                       for p in path)
        spec = tuple(sh.spec) + (None,) * (2 - len(sh.spec))
        node = got_tree
        for p in path:
            node = node[getattr(p, "key", getattr(p, "idx", None))]
        for placements in (got[key], node):
            assert len(placements) == len(shape)
            dim = pmesh.model_dim(placements)
            if spec[:2] == (None, "model"):
                assert dim == 1, key
            elif spec[:2] == ("model", None):
                assert dim == 0, key
            else:
                assert sh.spec == P() and dim is None, (key, sh.spec)
        split += dim is not None
    assert (split > 0) == (len(shape) == 2)
    replicated = pmesh.param_sharding(flat, fake, tensor_parallel=False)
    assert all(pmesh.model_dim(p) is None for p in replicated.values())


class _DataMesh(_FakeMesh):
    """A 3 x 2 ("data", "model") mesh seen from data rank `rank`."""

    def __init__(self, rank):
        super().__init__((3, 2), ("data", "model"))
        self.rank = rank

    def get_group(self, name):
        return None

    def get_local_rank(self, name):
        return self.rank


def _blocks_divide():
    """Leading dims that divide the data axis: contiguous blocks; dicts,
    lists and tuples walked, scalars kept, the model axis no split."""
    x = np.arange(12).reshape(6, 2)
    batch = {"x": x, "nested": {"y": np.arange(6)}, "scalar": 3,
             "pair": (np.arange(6), np.arange(3))}
    for r in range(3):
        g = pmesh.shard_batch(batch, _DataMesh(r))
        np.testing.assert_array_equal(g["x"], x[2 * r:2 * r + 2])
        np.testing.assert_array_equal(g["nested"]["y"], [2 * r, 2 * r + 1])
        assert g["scalar"] == 3
        assert isinstance(g["pair"], tuple)
        np.testing.assert_array_equal(g["pair"][0], [2 * r, 2 * r + 1])
        np.testing.assert_array_equal(g["pair"][1], [r])


def _blocks_uneven():
    """A leading dim that does not divide: numpy's array_split blocks
    (JAX would replicate the leaf), which cover the batch once."""
    for n in (5, 7, 4):
        x = np.arange(n)
        got = [pmesh.shard_batch({"o": x}, _DataMesh(r))["o"]
               for r in range(3)]
        for g, w in zip(got, np.array_split(x, 3)):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(np.concatenate(got), x)


def _blocks_bounds():
    """`block_bounds` is array_split's block, the first n % parts one row
    longer."""
    for n, parts in ((7, 2), (5, 3), (8, 4), (3, 3)):
        want = np.array_split(np.arange(n), parts)
        for i in range(parts):
            lo, hi = pmesh.block_bounds(n, parts, i)
            np.testing.assert_array_equal(np.arange(n)[lo:hi], want[i])


def _blocks_too_few_rows():
    with pytest.raises(ValueError, match="cannot be split over 3"):
        pmesh.shard_batch({"x": np.arange(2)}, _DataMesh(0))


def _blocks_no_mesh():
    batch = {"x": np.arange(5)}
    assert pmesh.shard_batch(batch, None) is batch


@pytest.mark.parametrize("case", [_blocks_divide, _blocks_uneven,
                                  _blocks_bounds, _blocks_too_few_rows,
                                  _blocks_no_mesh],
                         ids=lambda f: f.__name__[len("_blocks_"):])
def test_shard_batch_blocks(case):
    case()


@pytest.mark.parametrize("num_hosts", [1, 2, 3])
def test_loader_stripes_the_training_split_as_jax(tmp_path, num_hosts):
    from unpaired_image_captioning_tpu.data import synthetic as jsyn
    from unpaired_image_captioning_tpu.data.dataloader import (
        CaptionDataLoader as JLoader)
    from unpaired_image_captioning_tpu_torch.data.dataloader import (
        CaptionDataLoader)

    jpath, label, mem = jsyn.make_caption_artifacts(str(tmp_path),
                                                    n_images=14)
    seen = []
    for host in range(num_hosts):
        kw = dict(input_json=jpath, input_label_h5=label, in_memory=mem,
                  host_id=host, num_hosts=num_hosts)
        want = JLoader(**kw).split_ix
        got = CaptionDataLoader(**kw).split_ix
        assert got == want
        assert got["val"] == want["val"] and len(got["val"]) == 2
        seen += got["train"]
    assert sorted(seen) == list(range(10))


def test_make_mesh_checks_its_counts(tmp_path):
    assert launch.run_ranks(_mesh_counts, 2, (), timeout=JOB_TIMEOUT) == [
        True, True]
    with pytest.raises(RuntimeError, match="make_mesh needs"):
        pmesh.make_mesh(1)


def _mesh_counts(rank, world):
    m = pmesh.make_mesh(0, "1x2")
    assert m.mesh_dim_names == ("data", "model")
    assert pmesh.axis(m, "model")[1:] == (rank, 2)
    assert pmesh.axis(m, "data")[1:] == (0, 1)
    for args, msg in (((3, "data"), "num_devices 3 != 2"),
                      ((2, "2x2"), "mesh 2x2 != 2 devices")):
        try:
            pmesh.make_mesh(*args)
        except ValueError as e:
            assert msg in str(e), e
        else:
            raise AssertionError(f"make_mesh{args} did not raise")
    return pmesh.make_mesh(2, "data").mesh_dim_names == ("data",)


def test_run_ranks_reports_a_failing_rank():
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"):
        launch.run_ranks(_fails_on_rank_1, 2, (), timeout=JOB_TIMEOUT)


def _fails_on_rank_1(rank, world):
    import torch.distributed as dist

    if rank == 1:
        raise ValueError("rank 1 stops here")
    dist.barrier()      # rank 0 waits in a collective: it is terminated


# ---------------------------------------------------------------------------
# N-rank steps against the JAX one-device Trainer
# ---------------------------------------------------------------------------

NAMES = ["xe", "xe_uneven", "joint", "scst", "bn"]


@pytest.mark.parametrize("name", NAMES)
def test_two_rank_steps_match_jax_trainer(two_rank, scenarios, name):
    _held(two_rank, name, scenarios)
    assert two_rank[0][name][2] == {}         # nothing sharded on "2"


@pytest.mark.parametrize("name", NAMES)
def test_2x2_tensor_parallel_steps_match_jax_trainer(four_rank, scenarios,
                                                     name):
    result, _ = four_rank
    _held(result, name, scenarios)
    params = scenarios[name][2]
    for rank in result:
        shapes = rank[name][2]
        assert shapes, "no leaf was sharded"
        for leaf, shape in shapes.items():
            key, k = leaf.split(".", 1)
            whole = params[key][k].shape
            # half of the leaf on this rank, on one dim
            assert np.prod(shape) * 2 == np.prod(whole), leaf
            assert sum(a != b for a, b in zip(shape, whole)) == 1, leaf


def test_2x2_checkpoint_loads_into_one_device_trainer(four_rank, scenarios):
    from unpaired_image_captioning_tpu_torch.train.trainer import Trainer

    result, ckpt = four_rank
    cfg, _, extra, _, teacher, _ = scenarios["joint"][0]
    tr = Trainer(TConfig(**dict(cfg, checkpoint_path=ckpt, dtype="float32")),
                 device="cpu", **_port_extras(extra, cfg, teacher))
    infos = tr.load()
    assert infos["iter"] == tr.iteration == 2
    assert len(infos["data_generators"]) == 2
    want = result[0]["joint"][1]
    for key, model in tr._models():
        got = model.state_dict()
        assert set(got) == set(want[key])
        for k, v in want[key].items():
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    # the moments are whole too: one more step runs on one device
    assert tr.optim.i2t_state[1]["count"] == 2
    for k, p in tr.i2t_model.named_parameters():
        assert tr.optim.i2t_state[1]["mu"][k].shape == p.shape, k


def test_eval_split_on_two_ranks_equals_one(tmp_path):
    from unpaired_image_captioning_tpu_torch import models as tmodels
    from unpaired_image_captioning_tpu_torch.data import synthetic as tsyn
    from unpaired_image_captioning_tpu_torch.eval.eval_utils import (
        eval_split)

    artifacts = tsyn.make_caption_artifacts(
        str(tmp_path), n_images=16, vocab_size=V, seq_length=T, n_val=7,
        fc_dim=32, att_dim=24, seed=2)
    model = tmodels.setup(TConfig(**CAP), device="cpu").init_params(
        torch.Generator().manual_seed(3))
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    model, loader = _eval_setup(artifacts, state)
    want = eval_split(model, loader, split="val", beam_size=3,
                      eval_results_dir=str(tmp_path))
    got = launch.run_ranks(_eval_worker, 2,
                           (str(tmp_path), artifacts, state),
                           timeout=JOB_TIMEOUT)
    for out in got:
        assert [p["image_id"] for p in out["predictions"]] == list(
            range(7, 14))
        assert out["predictions"] == want["predictions"]
        np.testing.assert_allclose(out["loss"], want["loss"], rtol=1e-6)


def test_dryrun_multichip_on_four_cpu_ranks():
    from unpaired_image_captioning_tpu_torch.parallel.dryrun import (
        dryrun_multichip)

    report = dryrun_multichip(4, device="cpu", timeout=JOB_TIMEOUT)
    assert report["mesh"] == {"data": 2, "model": 2}
    assert np.isfinite(report["total_loss"])
    assert "wemb_loss" in report and "avg_reward" in report
