"""Flat <-> nested parameter trees for ``.npz`` files (the trained
discriminator's export).

The JAX package's ``checkpoints/flat.py`` layout: each leaf keyed by its
path joined with '/', list positions as bare integers
("blocks/0/conv1/weight"); on the way back every dict whose keys are all
numeric becomes a list.  A file written by either package loads in the other.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..utils.tree import tree_to


def flatten_params(params: Any) -> Dict[str, np.ndarray]:
    """Nested dicts / lists of tensors -> {"a/0/b": float32 ndarray}."""
    out: Dict[str, np.ndarray] = {}

    def walk(node, path):
        if isinstance(node, dict):
            items = sorted(node.items())  # the order of utils.tree.tree_leaves
        elif isinstance(node, (list, tuple)):
            items = enumerate(node)
        else:
            key = "/".join(path)
            if key in out:
                raise ValueError(f"duplicate flattened key {key!r}")
            out[key] = (node.detach().cpu().numpy() if isinstance(node, torch.Tensor)
                        else np.asarray(node))
            return
        for k, v in items:
            walk(v, path + [str(k)])

    walk(params, [])
    return out


def unflatten_params(flat: Dict[str, np.ndarray], device) -> Any:
    """Inverse of :func:`flatten_params`, leaves as float32 tensors on ``device``."""
    nested: Dict[str, Any] = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = nested
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def finalize(node):
        if not isinstance(node, dict):
            return node
        out = {k: finalize(v) for k, v in node.items()}
        if out and all(k.isdigit() for k in out):
            return [out[str(i)] for i in range(len(out))]
        return out

    return tree_to(finalize(nested), device)
