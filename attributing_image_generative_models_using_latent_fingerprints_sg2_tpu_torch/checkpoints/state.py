"""Attribution run state: save / resume.

A long attribution run checkpoints after every sample chunk: progress
cursor, per-sample results, the seed and the run's config in
``attribution_state.json``, the per-sample arrays in
``attribution_arrays.npz``.  File names and keys are those of the reference
package's ``checkpoints/state.py``, so a run directory written by either
package loads in the other.

The restart-initialization scheme (``--init`` and the encoder's budget) is
not part of the reference's saved state, so a resumed run there can mix two
schemes in one ``result.txt``.  The port writes it to a side file,
``init_scheme.json``, which the reference ignores.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

INIT_SCHEME_FILE = "init_scheme.json"


@dataclasses.dataclass
class AttributionRunState:
    """Resumable progress of a multi-chunk attribution run."""

    next_sample: int = 0
    bit_accs: List[float] = dataclasses.field(default_factory=list)
    success: int = 0
    seed: int = 0
    config: Optional[dict] = None


def _paths(run_dir: str) -> Tuple[str, str]:
    return (os.path.join(run_dir, "attribution_state.json"),
            os.path.join(run_dir, "attribution_arrays.npz"))


def save_state(run_dir: str, state: AttributionRunState,
               arrays: Optional[Dict[str, np.ndarray]] = None) -> None:
    """Persist the state (and the arrays, if any), each by write-then-rename."""
    os.makedirs(run_dir, exist_ok=True)
    jpath, apath = _paths(run_dir)
    tmp = jpath + ".tmp"
    with open(tmp, "w") as f:
        json.dump(dataclasses.asdict(state), f)
    os.replace(tmp, jpath)
    if arrays:
        tmp = apath + ".tmp.npz"
        np.savez(tmp, **{k: np.asarray(v) for k, v in arrays.items()})
        os.replace(tmp, apath)


def save_init_scheme(run_dir: str, scheme: Dict[str, object]) -> None:
    """Persist the run's restart-initialization scheme beside its state."""
    os.makedirs(run_dir, exist_ok=True)
    path = os.path.join(run_dir, INIT_SCHEME_FILE)
    with open(path + ".tmp", "w") as f:
        json.dump(scheme, f)
    os.replace(path + ".tmp", path)


def load_init_scheme(run_dir: str) -> Optional[Dict[str, object]]:
    """The saved scheme, or None for a directory without one (a run of the
    reference package, or one that predates the file)."""
    path = os.path.join(run_dir, INIT_SCHEME_FILE)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def load_state(run_dir: str) -> Tuple[Optional[AttributionRunState], Dict[str, np.ndarray]]:
    """(state, arrays), or (None, {}) when the directory holds no checkpoint."""
    jpath, apath = _paths(run_dir)
    if not os.path.exists(jpath):
        return None, {}
    with open(jpath) as f:
        state = AttributionRunState(**json.load(f))
    arrays: Dict[str, np.ndarray] = {}
    if os.path.exists(apath):
        with np.load(apath) as z:
            arrays = {k: z[k] for k in z.files}
    return state, arrays
