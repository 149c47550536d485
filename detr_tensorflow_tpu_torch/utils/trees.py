"""Tree inspection helpers (port of ``detr_tensorflow_tpu/utils/trees.py``):
a tree is a tensor, an array, or a dict, list or tuple of trees (a
``state_dict`` included)."""

from __future__ import annotations

import numpy as np
import torch


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, (torch.Tensor, np.ndarray)) or hasattr(tree, "shape"):
        yield tree


def _itemsize(x) -> int:
    dtype = x.dtype
    return dtype.itemsize if isinstance(dtype, torch.dtype) else np.dtype(dtype).itemsize


def tree_size(tree) -> int:
    """Total number of elements across all leaves."""
    return sum(int(np.prod(tuple(x.shape), dtype=np.int64)) for x in _leaves(tree))


def tree_bytes(tree) -> int:
    """Total bytes across all leaves."""
    return sum(int(np.prod(tuple(x.shape), dtype=np.int64)) * _itemsize(x) for x in _leaves(tree))


def print_tree_summary(tree, name: str = "params") -> None:
    """Element count and MB of ``tree``, then the element count of each
    top-level entry; a flat ``state_dict`` is grouped by the first part of
    its dotted names."""
    total = tree_size(tree)
    print(f"{name}: {total:,} elements ({tree_bytes(tree) / 1e6:.1f} MB)")
    if isinstance(tree, dict):
        groups = {}
        for key, sub in tree.items():
            groups.setdefault(str(key).split(".")[0], []).append(sub)
        for key, subs in groups.items():
            print(f"  {key:>24}: {tree_size(subs):,}")
