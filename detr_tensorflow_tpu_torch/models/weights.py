"""Weights in the JAX package's formats, read without JAX.

``load_variables_npz`` reads the ``.npz`` archive that the JAX package's
``save_variables_npz`` (and ``DetrModel.save``) writes: one array per
``collection/module/.../leaf`` path. ``from_jax_variables`` turns such a
variables tree into a state_dict of this package's modules, which are
named after the JAX tree.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

Tree = Dict[str, Any]


def load_variables_npz(path: str) -> Tree:
    """Nested dict of numpy arrays from a JAX ``save_variables_npz`` file."""
    tree: Tree = {}
    with np.load(path, allow_pickle=False) as data:
        for key in data.files:
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = data[key]
    return tree


def _flatten(node: Mapping, prefix: tuple = ()):
    for k, v in node.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def from_jax_variables(variables: Mapping) -> Dict[str, torch.Tensor]:
    """Map a JAX DETR variables tree ({"params": ..., "frozen": ...}) to a
    state_dict of ``models.detr.DETR``.

    * Dense kernel (in, out) -> Linear weight (out, in);
    * conv kernel HWIO -> Conv2d weight OIHW;
    * LayerNorm ``scale`` -> ``weight``;
    * the ``frozen`` collection -> FrozenBatchNorm buffers, names unchanged;
    * ``query_embed`` as it is.
    """
    state = {}
    for collection, tree in variables.items():
        if collection not in ("params", "frozen"):
            raise ValueError(f"unexpected variable collection {collection!r}")
        for path, value in _flatten(tree):
            arr = torch.from_numpy(np.array(value, dtype=np.float32))
            *modules, leaf = path
            if collection == "params" and leaf == "kernel":
                leaf = "weight"
                arr = arr.t() if arr.dim() == 2 else arr.permute(3, 2, 0, 1)
            elif collection == "params" and leaf == "scale":
                leaf = "weight"
            state[".".join(modules + [leaf])] = arr.contiguous()
    return state
