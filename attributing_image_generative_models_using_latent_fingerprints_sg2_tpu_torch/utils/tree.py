"""Parameter trees: nested dicts/lists of tensors, as the reference's pytrees."""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def tree_to(tree: Any, device=None, dtype=torch.float32) -> Any:
    """Map a nested dict/list/tuple of arrays (numpy, JAX or torch) to
    float32 tensors on ``device``; tuples become lists."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_to(v, device, dtype) for v in tree]
    if tree is None:
        return None
    if not isinstance(tree, torch.Tensor):
        tree = torch.from_numpy(np.array(tree, dtype=np.float32))
    return tree.to(device=device, dtype=dtype)


def tree_leaves(tree: Any) -> list:
    """The leaves of a nested dict/list tree in JAX's order (dict keys sorted,
    lists in order), Nones left out: two trees of one structure pair up leaf
    for leaf whatever order their dicts were built in."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [] if tree is None else [tree]


def tree_map(fn, tree: Any) -> Any:
    """``fn`` applied to every leaf, in :func:`tree_leaves`' order; the
    structure kept (tuples become lists)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return None if tree is None else fn(tree)
