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


def params_to_numpy(module: nn.Module) -> dict:
    """The inverse of `params_from_jax`: the module's state as a nested tree
    of numpy arrays in the JAX package's layout."""
    root: dict = {}
    for key, t in module.state_dict().items():
        node = root
        *path, leaf = key.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = t.detach().cpu().numpy().copy()
    return _listify(root)
