"""The device trace of a run's window (``torch.profiler``, CUPTI) reduced to
what the per-layer metrics and the breakdown read: the seconds in which an
operation ran on the card, the window's length, the device operations that
took the most time, and the idle gaps by what the host was doing.

The trace is kept in memory by the profiler, written once to a temporary
file for its Chrome-trace form, read and deleted.
"""

from __future__ import annotations

import heapq
import json
import os
import tempfile
from typing import Any, Callable, Dict, List, Tuple

WINDOW = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
TOP = 10
NAME_CHARS = 160  # kernel names are long templates: the head names them


def warm(device) -> None:
    """One short profiled op, so the profiler's start-up is set-up and not window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(8, device=device).add_(1)
        torch.cuda.synchronize(device)


def traced(fn: Callable[[], Any]) -> Tuple[Any, Dict[str, Any]]:
    """Run ``fn`` under the profiler inside a ``WINDOW`` annotation that ends
    with a synchronize; return its result and :func:`summarize` of the trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            out = fn()
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(prefix="portbench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.unlink(path)
    return out, summarize(trace)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1] = (merged[-1][0], b)
        else:
            merged.append((a, b))
    return merged


def summarize(trace: Any) -> Dict[str, Any]:
    """Busy and window seconds, the top device operations by time, and the
    idle gaps named by the innermost host event running at their middle
    ("host, no op" where none), summed by name; timestamps in microseconds."""
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    spans = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW and e.get("cat") != "gpu_user_annotation"]
    if not spans:
        raise RuntimeError("the trace holds no window annotation")
    w0 = float(spans[0]["ts"])
    w1 = w0 + float(spans[0]["dur"])
    dev, by_name = [], {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a, b = max(float(e["ts"]), w0), min(float(e["ts"]) + float(e.get("dur", 0.0)), w1)
        if b > a:
            dev.append((a, b))
            name = e["name"][:NAME_CHARS]
            by_name[name] = by_name.get(name, 0.0) + (b - a)
    if not dev:
        raise RuntimeError("the trace holds no device operation inside the window")
    busy = _union(dev)
    gaps, prev = [], w0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = b
    if w1 > prev:
        gaps.append((prev, w1))
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"][:NAME_CHARS]) for e in events
                  if e.get("ph") == "X" and e.get("cat") in HOST_CATS and e.get("name") != WINDOW)
    gap_names: Dict[str, float] = {}
    heap: List[Tuple[float, float, str]] = []  # (-start, end, name) of host events begun by the gap's middle
    i = 0
    for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = 0.5 * (a + b)
        while i < len(host) and host[i][0] <= mid:
            heapq.heappush(heap, (-host[i][0], host[i][1], host[i][2]))
            i += 1
        while heap and heap[0][1] <= mid:
            heapq.heappop(heap)
        name = heap[0][2] if heap else "host, no op"
        gap_names[name] = gap_names.get(name, 0.0) + (b - a)
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    top_gaps = sorted(gap_names.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": sum(b - a for a, b in busy) / 1e6, "window_s": (w1 - w0) / 1e6,
            "device_ops": [[n, t / 1e6] for n, t in top_ops], "idle_gaps": [[n, t / 1e6] for n, t in top_gaps]}
