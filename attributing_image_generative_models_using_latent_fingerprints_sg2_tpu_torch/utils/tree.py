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
