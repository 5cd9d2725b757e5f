"""Crash-safe training snapshots: save and resume the whole TrainState.

Generator, discriminator, EMA, both Adam states and the step counter go into
one ``.npz`` of positional leaves plus a JSON meta blob.  The structure is
not stored: the loader rebuilds it from a template state made by
``init_train_state`` with the same configs, and refuses a file whose leaf
count, shapes, dtypes or run meta differ.  Writes are atomic (a temporary
file, flushed to disk, then ``os.replace``), so a crash mid-write leaves the
previous snapshot intact.  With the step draws a function of (seed, step)
(``gan.draw_step``), a resumed run continues the uninterrupted one bit for
bit on the CPU.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ..utils.tree import tree_leaves, tree_map
from .gan import TrainState


def _trees(state: TrainState) -> List[Any]:
    return [state.g_params, state.d_params, state.g_ema, state.g_opt, state.d_opt]


def _arrays(state: TrainState) -> List[np.ndarray]:
    """The state's leaves in a fixed order; step and Adam counts as int64."""
    leaves = [state.step] + tree_leaves(_trees(state))
    return [t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.int64)
            for t in leaves]


def save_snapshot(path: str, state: TrainState, meta: Dict[str, Any]) -> None:
    payload = {f"leaf_{i}": a for i, a in enumerate(_arrays(state))}
    payload["meta"] = np.asarray(json.dumps(meta))
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def load_snapshot(path: str, template: TrainState) -> Tuple[TrainState, Dict[str, Any]]:
    """The state saved at ``path``, on the template's devices, and its meta."""
    want = _arrays(template)
    devices = [None] + [t.device if isinstance(t, torch.Tensor) else None for t in tree_leaves(_trees(template))]
    with np.load(path) as data:
        meta = json.loads(str(data["meta"]))
        n = sum(1 for k in data.files if k.startswith("leaf_"))
        if n != len(want):
            raise ValueError(f"snapshot {path!r} has {n} leaves, the template state {len(want)}; "
                             "config mismatch?")
        leaves = []
        for i, (w, dev) in enumerate(zip(want, devices)):
            a = data[f"leaf_{i}"]
            if a.shape != w.shape or a.dtype != w.dtype:
                raise ValueError(f"snapshot leaf {i} is {a.shape}/{a.dtype}, "
                                 f"the template expects {w.shape}/{w.dtype}")
            leaves.append(int(a) if dev is None else torch.from_numpy(a).to(dev))
    rest = iter(leaves[1:])
    g_params, d_params, g_ema, g_opt, d_opt = tree_map(lambda _: next(rest), _trees(template))
    return TrainState(leaves[0], g_params, d_params, g_ema, g_opt, d_opt), meta


def check_meta(meta: Dict[str, Any], expected: Dict[str, Any]) -> None:
    """Raise if any run-defining field differs from the snapshot's."""
    for k, v in expected.items():
        if meta.get(k) != v:
            raise ValueError(f"snapshot was taken with {k}={meta.get(k)!r}, this run has {k}={v!r}; "
                             "refusing to resume across configs")
