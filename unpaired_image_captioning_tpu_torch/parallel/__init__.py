"""Scale-out on `torch.distributed` (counterpart of
`unpaired_image_captioning_tpu/parallel/`).

One process a rank, one rank a card (or a CPU rank over gloo). A
`DeviceMesh` names the axes: "data" splits the global batch into
contiguous blocks, and an optional "model" axis holds the tensor-parallel
leaves in shards (`mesh.py`). The trainer's N-rank step computes the
one-device step on the global batch (`train/trainer.py`); `launch.py`
starts and joins the ranks; `dryrun.py` drives the whole training and
decode surface under a mesh."""

from .mesh import make_mesh, param_sharding, replicate, shard_batch
