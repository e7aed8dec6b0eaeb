"""Parameter bridge between the JAX package's parameter trees and the port's
modules.

The port names its parameters after the JAX tree's keys, so the bridge is a
key-for-key copy: nested dicts join their keys with dots and lists
contribute their index (`{"core": {"lstm0": {"w": ...}}}` <->
`core.lstm0.w`, `{"logit": [{"w": ...}]}` <-> `logit.0.w`). Leaves are
array-likes (numpy arrays, or anything `np.asarray` accepts); no jax import
is needed.

    model.load_state_dict(params_from_jax(jax_params))
    jax_like_tree = params_to_numpy(model)

The ResNet's conv weights change layout on the way (HWIO -> OIHW):

    resnet.load_state_dict(resnet_state_from_jax(jax_resnet_params))

The optimizer state maps the same way: each part of an optax chain state
(`ScaleByAdamState(count, mu, nu)`, `TraceState(trace)`, ...) becomes a
dict of the same field names in the port's `train/optimizer.py`, with the
moment trees as name -> tensor dicts and `count` as an int, so that a run
can resume across the two frameworks:

    trainer.optim.i2t_state = opt_state_from_optax(jax_opt_state, device=dev)
    jax_opt_state = opt_state_to_optax(trainer.optim.i2t_state, template)

`template` is an optax state of the same chain (for example
`tx.init(params)` on the JAX side): only its structure is used, and its
named tuples are rebuilt with `_replace`, so no optax import is needed.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn


def _flatten(tree: Any, prefix: str, out: dict) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}.", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}{i}.", out)
    else:
        out[prefix[:-1]] = torch.from_numpy(np.array(tree, copy=True))


def params_from_jax(tree: Any) -> dict:
    """JAX parameter tree -> state_dict of CPU tensors (dot-joined keys)."""
    out: dict = {}
    _flatten(tree, "", out)
    return out


def _listify(node: Any) -> Any:
    """Dicts whose keys are exactly 0..n-1 become lists, recursively."""
    if not isinstance(node, dict):
        return node
    node = {k: _listify(v) for k, v in node.items()}
    if node and all(k.isdigit() for k in node):
        idx = sorted(int(k) for k in node)
        if idx == list(range(len(idx))):
            return [node[str(i)] for i in idx]
    return node


def tree_from_flat(flat: dict) -> Any:
    """Dot-joined name -> tensor dict -> nested tree of numpy arrays in the
    JAX package's layout (the inverse of `params_from_jax`)."""
    root: dict = {}
    for key, t in flat.items():
        node = root
        *path, leaf = key.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = t.detach().cpu().numpy().copy()
    return _listify(root)


def resnet_state_from_jax(tree: Any) -> dict:
    """The JAX package's ResNet tree (`ResNet.init_params` or
    `convert_torchvision_state_dict` output; conv weights HWIO) -> the
    state dict of the port's `models.resnet.ResNet` (conv weights OIHW)."""
    return {k: (t.permute(3, 2, 0, 1).contiguous() if t.dim() == 4 else t)
            for k, t in params_from_jax(tree).items()}


def params_to_numpy(module: nn.Module) -> dict:
    """The inverse of `params_from_jax`: the module's state as a nested tree
    of numpy arrays in the JAX package's layout."""
    return tree_from_flat(module.state_dict())


def opt_state_from_optax(state: Any, *, device="cpu") -> list:
    """An optax chain state (a tuple of named tuples) -> the port's state:
    one dict per part, `count` as an int, every other field as a name ->
    tensor dict on `device`."""
    out = []
    for part in state:
        d = {}
        for name in getattr(part, "_fields", ()):
            value = getattr(part, name)
            if name == "count":
                d[name] = int(np.asarray(value))
            else:
                d[name] = {k: t.to(device)
                           for k, t in params_from_jax(value).items()}
        out.append(d)
    return out


def opt_state_to_optax(state: list, template: Any) -> tuple:
    """The port's optimizer state -> `template`'s optax structure, with
    numpy leaves."""
    parts = []
    for d, tmpl in zip(state, template):
        fields = {name: (np.asarray(value, np.int32) if name == "count"
                         else tree_from_flat(value))
                  for name, value in d.items()}
        parts.append(tmpl._replace(**fields) if fields else tmpl)
    return tuple(parts)
