"""Run directories, config snapshots, ``result.txt`` and checkpointed jsonl.

Same layout and format as the reference package's ``utils/io.py``
(ref ``src/utils.py:23-34``, ``src/main.py:18-21,151-154``).
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import os
import sys
from typing import Any, List


def make_run_dir(save_dir: str, augmentation: str, sigma: float, shift: int) -> str:
    """``{save_dir}/{augmentation}/fixed_sigma_{sigma}/shift_{shift}/``, dots stripped."""
    sub = "{}/fixed_sigma_{}/shift_{}/".format(augmentation, sigma, shift).replace(".", "")
    return os.path.join(save_dir, sub)


def save_config(save_dir: str, cfg: Any) -> str:
    """Create a timestamped run dir holding ``sampling_config.yaml``; return it."""
    import yaml

    now = datetime.datetime.now().strftime("%Y-%m-%d-%H-%M-%S")
    run_dir = os.path.join(save_dir, now, "")
    os.makedirs(run_dir, exist_ok=True)
    if dataclasses.is_dataclass(cfg) and not isinstance(cfg, type):
        cfg = dataclasses.asdict(cfg)
    with open(os.path.join(run_dir, "sampling_config.yaml"), "w") as f:
        yaml.dump(cfg, f, default_flow_style=False)
    return run_dir


def write_results(run_dir: str, bit_accs: List[float], attribution_acc: float) -> str:
    """Rewrite ``result.txt``: per-sample bit accuracy + attribution accuracy."""
    path = os.path.join(run_dir, "result.txt")
    with open(path, "w") as f:
        for i, acc in enumerate(bit_accs):
            f.write(
                "\n sample index: {}, bit acc: {}, attribution acc: {}".format(
                    i, float(acc), attribution_acc
                )
            )
    return path


def read_jsonl_resumable(path: str) -> List[dict]:
    """The records of a jsonl file written one line per finished point,
    tolerating ONE torn final line (a process killed mid-append leaves a
    partial record: it is dropped, so the writer reruns that point).  A
    malformed line anywhere else is corruption and raises.  The study
    driver's resume and the report read records through this one function."""
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    recs: List[dict] = []
    for i, line in enumerate(lines):
        try:
            recs.append(json.loads(line))
        except json.JSONDecodeError:
            if i == len(lines) - 1:
                print(f"[jsonl] dropping torn trailing line in {path}", file=sys.stderr)
                continue
            raise
    return recs
