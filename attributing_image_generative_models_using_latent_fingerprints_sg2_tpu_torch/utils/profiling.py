"""Phase timers and a profiler trace (the reference package's ``utils/profiling.py``).

- ``phase(name)``: wall-clock phase timer with a process-global report
  (host-side; waits for nothing).
- ``device_phase(name)``: like ``phase``, but before the clock stops it
  waits for the device work behind the tensors appended to its box
  (``fence``): CUDA launches return before the device finishes.
- ``trace(log_dir, device)``: ``torch.profiler`` over the enclosed block,
  written as a Chrome trace (``chrome://tracing`` or Perfetto open it).
"""

from __future__ import annotations

import contextlib
import os
import re
import time
from collections import defaultdict
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from .tree import tree_leaves

_PHASES: Dict[str, list] = defaultdict(list)


@contextlib.contextmanager
def phase(name: str) -> Iterator[None]:
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _PHASES[name].append(time.perf_counter() - t0)


def fence(x: Any) -> None:
    """Wait until the device work behind every tensor leaf of ``x`` is done:
    one ``torch.cuda.synchronize`` for each CUDA device among them.  Nothing
    is copied to the host; CPU tensors are ready when they are returned."""
    for device in {leaf.device for leaf in tree_leaves(x) if torch.is_tensor(leaf) and leaf.is_cuda}:
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def device_phase(name: str, result_box: Optional[list] = None) -> Iterator[list]:
    """Phase timer that fences on the device results appended to the box."""
    box = result_box if result_box is not None else []
    t0 = time.perf_counter()
    try:
        yield box
    finally:
        for r in box:
            fence(r)
        _PHASES[name].append(time.perf_counter() - t0)


def report(reset: bool = False) -> Dict[str, Dict[str, float]]:
    out = {}
    for name, times in _PHASES.items():
        arr = np.asarray(times)
        out[name] = {
            "count": int(arr.size),
            "total_s": float(arr.sum()),
            "mean_s": float(arr.mean()),
            "min_s": float(arr.min()),
            "max_s": float(arr.max()),
        }
    if reset:
        _PHASES.clear()
    return out


def format_report(reset: bool = False) -> str:
    rows = ["phase                          count   total     mean"]
    for name, st in sorted(report(reset).items(), key=lambda kv: -kv[1]["total_s"]):
        rows.append(
            f"{name:<30} {st['count']:>5} {st['total_s']:>8.2f}s {st['mean_s']*1000:>8.1f}ms"
        )
    return "\n".join(rows)


@contextlib.contextmanager
def trace(log_dir: str, device) -> Iterator[None]:
    """``torch.profiler`` trace of the enclosed block, CPU and (on a CUDA
    ``device``) CUDA activities, written to ``log_dir/trace_<pid>.json``.

    On a CUDA device the trace must record the card: a profiler that does not
    start raises, and so does a trace that holds no kernel.  On the CPU, as in
    the reference package, a profiler that will not start is a printed
    warning and the block runs untraced."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    prof = profile(activities=activities)
    try:
        prof.start()
    except RuntimeError as e:
        if cuda:
            raise
        print(f"[profiling] trace unavailable: {type(e).__name__}: {e}")
        prof = None
    try:
        yield
    finally:
        if prof is not None:
            if cuda:
                torch.cuda.synchronize(device)
            prof.stop()
            os.makedirs(log_dir, exist_ok=True)
            path = os.path.join(log_dir, f"trace_{os.getpid()}.json")
            prof.export_chrome_trace(path)
            if cuda:
                with open(path) as f:
                    if not re.search(r'"cat":\s*"kernel"', f.read()):
                        raise RuntimeError(f"the profiler recorded no CUDA kernel in {path}")
