"""Device mesh and sharding rules on `torch.distributed` (counterpart of
`unpaired_image_captioning_tpu/parallel/mesh.py`).

The JAX package places arrays on a `jax.sharding.Mesh` and lets XLA
insert the collectives. Here each rank is a process and the mesh is a
`DeviceMesh` over the process group:

- `make_mesh` builds the 1-D mesh ("data") or the 2-D ("data", "model")
  mesh of "DxM";
- `shard_batch` gives each data rank its contiguous block of the global
  batch (the same block on every model rank), in uneven blocks where the
  leading dim does not divide the data axis (JAX replicates such a leaf);
- `param_sharding` gives each parameter its placements, one a mesh dim:
  `_tp_spec`'s rules, with JAX's `P(None, "model")` as `Shard(1)` and
  `P("model", None)` as `Shard(0)` on the model dim (the port keeps JAX's
  [in, out] layouts, so the dims are the same).

The rest is what the trainer needs that XLA does for JAX:
`block_bounds` (the uneven blocks, which the trainer weighs by their
counts), `data_parallel` / `global_sum` / `mean_share` (the global counts
of the masked means, and the global sums that must be whole on every
rank, such as the BatchNorm moments, differentiable), `ModelShards` (the
tensor-parallel leaves held in shards and gathered whole for the step),
and `gather_objects`. A tensor on the card under gloo goes through a
host copy.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard

# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------


def make_mesh(num_devices: int = 0, mesh_shape: str = "data", *,
              device_type: Optional[str] = None) -> DeviceMesh:
    """mesh_shape: "data" (1-D) or "DxM" (data x model), over the ranks of
    the initialised process group. `num_devices` 0 takes every rank; any
    other count must be the group's size. `device_type` defaults to "cuda"
    under NCCL and "cpu" otherwise (ranks that share a card over gloo
    hold CUDA tensors on a "cpu" mesh: the mesh only names the groups)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group: "
                           "start the ranks with parallel.launch or torchrun")
    n = dist.get_world_size()
    if num_devices and num_devices != n:
        raise ValueError(f"num_devices {num_devices} != {n} ranks in the "
                         "process group")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    if "x" in mesh_shape:
        d, m = (int(v) for v in mesh_shape.split("x"))
        if d * m != n:
            raise ValueError(f"mesh {d}x{m} != {n} devices")
        return init_device_mesh(device_type, (d, m),
                                mesh_dim_names=("data", "model"))
    return init_device_mesh(device_type, (n,), mesh_dim_names=("data",))


def axis(mesh: Optional[DeviceMesh], name: str):
    """(process group, this rank's index, size) of one mesh axis; (None, 0,
    1) without a mesh or without that axis."""
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return None, 0, 1
    return (mesh.get_group(name), mesh.get_local_rank(name),
            mesh.size(mesh.mesh_dim_names.index(name)))


def replicate(mesh: DeviceMesh) -> Tuple:
    return tuple(Replicate() for _ in mesh.mesh_dim_names)


def block_bounds(n: int, parts: int, index: int) -> Tuple[int, int]:
    """[lo, hi) of block `index` of `n` rows in `parts` contiguous blocks,
    the first n % parts one row longer (numpy's array_split)."""
    base, extra = divmod(n, parts)
    lo = index * base + min(index, extra)
    return lo, lo + base + (1 if index < extra else 0)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(batch: Any, mesh: Optional[DeviceMesh]) -> Any:
    """This data rank's contiguous block of every array leaf of `batch`
    (dicts, lists and tuples are walked; the model axis does not split
    it), in `block_bounds`' uneven blocks where the leading dim does not
    divide the data axis: the trainer weighs each block by its counts, so
    the step is the global batch's. (JAX replicates such a leaf instead.)
    Raises when a leaf has fewer rows than the data axis has ranks."""
    if mesh is None:
        return batch
    _, r, n = axis(mesh, "data")
    return _map(lambda x: (take_block(x, n, r) if getattr(x, "ndim", 0)
                           else x), batch)


def take_block(x, parts: int, index: int):
    """Rows `block_bounds(len(x), parts, index)` of `x`; raises when `x`
    has fewer rows than `parts`."""
    if x.shape[0] < parts:
        raise ValueError(f"a batch leaf of {x.shape[0]} rows cannot be "
                         f"split over {parts} data ranks")
    lo, hi = block_bounds(x.shape[0], parts, index)
    return x[lo:hi]


# ---------------------------------------------------------------------------
# parameter placements
# ---------------------------------------------------------------------------


def _tp_spec(path: str, leaf, mesh: DeviceMesh) -> Optional[int]:
    """The tensor-parallel rule of one leaf: the dim it is split on over
    "model", or None (replicated). Only on meshes with a model axis: gate
    matmuls on their output columns, embeddings and vocab projections on
    the vocab dim."""
    if "model" not in (mesh.mesh_dim_names or ()):
        return None
    if leaf.ndim == 2:
        pathl = path.lower()
        if any(k in pathl for k in ("logit", "generator", "embed",
                                    "word_lut")):
            return 1 if "w" in pathl.split("/")[-1] else 0
        if leaf.shape[-1] % mesh.size(mesh.mesh_dim_names.index("model")) == 0:
            return 1
    return None


def _placements(mesh: DeviceMesh, dim: Optional[int]) -> Tuple:
    return tuple(Shard(dim) if n == "model" and dim is not None
                 else Replicate() for n in mesh.mesh_dim_names)


def param_sharding(params, mesh: Optional[DeviceMesh],
                   tensor_parallel: bool = False):
    """Placements (one a mesh dim) for each leaf of `params`: a name ->
    tensor dict with dot-joined names (`named_parameters()`), or a nested
    tree of dicts and lists. Replicated, or `_tp_spec`'s rules with
    `tensor_parallel`. The rules read the JAX path ("/core/lstm0/w" for
    "core.lstm0.w")."""
    if mesh is None:
        return None
    if not tensor_parallel:
        return _map(lambda _: replicate(mesh), params)

    def walk(tree, path=""):
        if isinstance(tree, dict):
            return {k: walk(v, f"{path}/{k}".replace(".", "/"))
                    for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, f"{path}/{i}")
                              for i, v in enumerate(tree))
        return _placements(mesh, _tp_spec(path, tree, mesh))

    return walk(params)


def model_dim(placements: Sequence) -> Optional[int]:
    """The dim a leaf is split on over "model" (its `Shard`), or None."""
    for p in placements:
        if isinstance(p, Shard):
            return p.dim
    return None


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def _staged(t: torch.Tensor, group, fn) -> torch.Tensor:
    """Run the in-place collective `fn` on `t`, through a host copy when
    the group is gloo and `t` lies on the card."""
    if t.is_cuda and dist.get_backend(group) == "gloo":
        host = t.cpu()
        fn(host)
        t.copy_(host)
    else:
        fn(t)
    return t


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum `t` over `group`, in place."""
    return _staged(t, group, lambda x: dist.all_reduce(x, group=group))


def broadcast_(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """`t` of global rank `src` on every rank of `group`, in place."""
    return _staged(t, group,
                   lambda x: dist.broadcast(x, src=src, group=group))


def all_gather_cat(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The shards of every rank of `group`, concatenated on `dim` in rank
    order (equal shapes)."""
    size = dist.get_world_size(group)
    src = t.detach().contiguous()
    if src.is_cuda and dist.get_backend(group) == "gloo":
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(size)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim).to(t.device)


def gather_objects(obj, group=None) -> List[Any]:
    """Every rank's `obj` (picklable), in rank order, on every rank."""
    out: List[Any] = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group whose backward sums the incoming gradients: every
    rank's loss then reaches every rank's inputs, as one device's would."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


_DATA_GROUP: contextvars.ContextVar = contextvars.ContextVar(
    "data_group", default=None)


@contextlib.contextmanager
def data_parallel(group):
    """Within the block, `global_sum` sums over `group` (the data axis).
    With None it is the identity, as on one device."""
    token = _DATA_GROUP.set(group)
    try:
        yield
    finally:
        _DATA_GROUP.reset(token)


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """`x` summed over the data ranks of the enclosing `data_parallel`
    block (differentiably where `x` needs a gradient); `x` itself outside
    one. The criteria divide their local sums by such global counts, so
    the ranks' losses add up to the global batch's. The sum is taken in
    f32 whatever x's type (the compute dtype's bf16 steps too)."""
    group = _DATA_GROUP.get()
    if group is None:
        return x
    x = x.float()
    if x.requires_grad:
        return _AllReduceSum.apply(x, group)
    return all_reduce_(x.detach().clone(), group)


def mean_share(x: torch.Tensor) -> torch.Tensor:
    """This rank's share of the mean of every data rank's `x`: its local
    sum over the global count, so the shares add up to the global batch's
    mean (the plain mean outside a `data_parallel` block)."""
    if _DATA_GROUP.get() is None:
        return x.mean()
    count = torch.tensor(float(x.numel()), dtype=x.dtype, device=x.device)
    return x.sum() / global_sum(count)


def data_parallel_active() -> bool:
    return _DATA_GROUP.get() is not None


class ModelShards:
    """The tensor-parallel leaves of one model on this rank. Each leaf the
    placements split over "model" lives as this rank's 1/M slice between
    steps (`shard`); `unshard` gathers them whole for the step's kernels,
    which see plain contiguous tensors; `slice` cuts a whole tensor (a
    reduced gradient, an optimizer moment) to this rank's shard."""

    def __init__(self, model: torch.nn.Module, mesh: DeviceMesh,
                 placements: Dict[str, Tuple]):
        self.group, self.rank, self.size = axis(mesh, "model")
        self.params = dict(model.named_parameters())
        self.dims: Dict[str, int] = {}
        for name, pl in placements.items():
            dim = model_dim(pl)
            if dim is None:
                continue
            shape = tuple(self.params[name].shape)
            if shape[dim] % self.size:
                raise ValueError(f"{name} {shape}: dim {dim} does not divide "
                                 f"the model axis of {self.size}")
            self.dims[name] = dim
        self.whole = True

    def slice(self, name: str, t: torch.Tensor) -> torch.Tensor:
        return t.chunk(self.size, self.dims[name])[self.rank].clone()

    @torch.no_grad()
    def shard(self) -> None:
        if self.whole:
            for name in self.dims:
                p = self.params[name]
                p.data = self.slice(name, p.data)
            self.whole = False

    @torch.no_grad()
    def unshard(self) -> None:
        if not self.whole:
            for name, dim in self.dims.items():
                p = self.params[name]
                p.data = all_gather_cat(p.data, dim, self.group)
            self.whole = True

    def gather(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """A shard-shaped tensor of leaf `name`, whole."""
        return all_gather_cat(t, self.dims[name], self.group)
