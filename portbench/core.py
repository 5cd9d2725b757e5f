"""Finding a cell's files by name, running the cell once, and assembling its result.

A cell names a configuration (``configs/<config>.json``) and a traffic mix
(``traffic/<mix>.json``); the mix's ``kind`` names the driver of its
requests (``kinds/<kind>.py``); ``workloads/<cell>.json`` holds the cell's
limits for the comparison; each metric of the cell in ``BENCHMARK.json`` has
its reader ``metrics/<metric>.py``.  Nothing here names a cell, a
configuration, a mix or a metric.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import random
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
PORT = "attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "attributing_image_generative_models_using_latent_fingerprints_sg2_tpu")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
# the control: the reference one precision below the cell's compute dtype
CONTROL = {"float32": "tf32", "bfloat16": "fp8"}


class SpecError(ValueError):
    """A cell, configuration, mix or metric that its files do not define."""


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def _named(kind: str, name: str, suffix: str = ".json") -> Path:
    if not NAME.match(name):
        raise SpecError(f"{kind} name {name!r} is not a name")
    path = ROOT / kind / f"{name}{suffix}"
    if not path.is_file():
        raise SpecError(f"no {kind} file {path.relative_to(REPO)}")
    return path


def load_file_module(path: Path, tag: str):
    spec = importlib.util.spec_from_file_location(f"portbench_{tag}_{re.sub(r'[^A-Za-z0-9_]', '_', path.stem)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """The reader of metric ``name``: ``metrics/<name>.py``, whose
    ``read(run)`` returns the value or None where it finds nothing to read."""
    return load_file_module(_named("metrics", name, ".py"), "metric")


def cell_metrics(manifest: dict, cell: str, trace: bool) -> List[dict]:
    """The cell's end-to-end metrics (``trace`` false) or per-layer ones: the
    entries that list the cell (an end-to-end metric without a list goes with
    every cell)."""
    if not trace:
        return [m for m in manifest["end_to_end"] if cell in m.get("workloads", [cell])]
    return [m for m in manifest["per_layer"] if cell in m["workloads"]]


@dataclasses.dataclass
class Plan:
    """Everything that defines one cell, read from its files."""

    cell: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    metrics: List[dict]  # end-to-end and per-layer entries of BENCHMARK.json
    manifest: dict = dataclasses.field(default_factory=dict)


def plan(cell: str, manifest: Optional[dict] = None) -> Plan:
    """Read cell ``cell`` from ``BENCHMARK.json`` and its files; raise
    :class:`SpecError` where they are missing."""
    manifest = manifest if manifest is not None else load_json(REPO / "BENCHMARK.json")
    entry = [w for w in manifest["workloads"] if w["name"] == cell]
    if not entry:
        raise SpecError(f"BENCHMARK.json has no workload {cell!r}")
    entry = entry[0]
    limits = load_json(_named("workloads", cell))["limits"]
    config = load_json(_named("configs", entry["config"]))
    traffic = load_json(_named("traffic", entry["traffic"]))
    metrics = cell_metrics(manifest, cell, False) + cell_metrics(manifest, cell, True)
    for m in metrics:
        _named("metrics", m["name"], ".py")
    return Plan(cell=cell, chips=int(entry["chips"]), config=config, traffic=traffic,
                limits=dict(limits), metrics=metrics, manifest=manifest)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, or exactly the JAX package's."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def driver_module(kind: str):
    if not NAME.match(kind) or not (ROOT / "kinds" / f"{kind}.py").is_file():
        raise SpecError(f"no request kind {kind!r} (kinds/<kind>.py)")
    return importlib.import_module(f"portbench.kinds.{kind}")


# ---------------------------------------------------------------------------
# One run
# ---------------------------------------------------------------------------


class Reservoir:
    """A uniform sample of ``k`` of the requests offered, drawn from the seed,
    whatever their number: the comparison's sample of the window's answers."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.seen, self.items = k, random.Random(seed), 0, []

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.k:
                self.items[j] = item
        self.seen += 1


def sync(device) -> None:
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Run:
    """What readers read: the plan, the window, the trace and the driver's probes."""

    plan: Plan
    seed: int
    seconds: float
    trace: bool
    device: Any
    driver: Any = None
    setup_s: float = 0.0
    window: Dict[str, Any] = dataclasses.field(default_factory=dict)
    traced: Optional[Dict[str, Any]] = None
    _layers: Dict[str, Optional[float]] = dataclasses.field(default_factory=dict)

    @property
    def config(self) -> dict:
        return self.plan.config

    @property
    def traffic(self) -> dict:
        return self.plan.traffic

    @property
    def dtype(self) -> str:
        return self.plan.traffic.get("dtype", "float32")

    def layer_share(self, layer: str) -> Optional[float]:
        """Percent of the bound of ``layer``'s work (the frozen counts) in its
        device time: the driver's probe of the layer at the cell's batch and
        dtype, CUDA events, median of repeats.  None where the cell has no
        such layer or no card."""
        if layer not in self._layers:
            self._layers[layer] = None
            probe = self.driver.probe(layer) if self.device.type == "cuda" else None
            if probe is not None:
                from portbench.flops.peaks import bound_s

                fn, counts = probe
                self._layers[layer] = 100.0 * bound_s(counts["flops"], counts["bytes"], self.dtype) / time_device(fn)
        return self._layers[layer]


def time_device(fn: Callable[[], Any], warm: int = 2, reps: int = 7) -> float:
    """Median seconds of ``fn`` on the card, CUDA events around each call."""
    import torch

    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / 1e3)
    return statistics.median(times)


def measure(driver, seconds: float, device, max_requests: Optional[int] = None) -> Dict[str, Any]:
    """Closed loop: one caller, each request issued when the last has returned,
    until ``seconds`` have passed (or ``max_requests`` have run).  The window
    runs from the first issue to the last answer; its peak memory is the
    allocator's peak inside it."""
    import torch

    sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    counts, attempted, failed = {}, 0, 0
    t0 = time.perf_counter()
    while True:
        ok, work = driver.request(attempted)
        attempted += 1
        failed += 0 if ok else 1
        for k, v in work.items():
            counts[k] = counts.get(k, 0) + v
        if max_requests is not None:
            if attempted >= max_requests:
                break
        elif time.perf_counter() - t0 >= seconds:
            break
    sync(device)
    t1 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    return {"seconds": t1 - t0, "counts": counts, "attempted": attempted,
            "failed": failed, "peak_bytes": int(peak)}


def card_info(device) -> Dict[str, Any]:
    import torch

    info = {"platform": "gpu" if device.type == "cuda" else device.type,
            "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"}
    if device.type == "cuda":
        try:
            out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                 capture_output=True, text=True, timeout=30)
            info["nvidia_smi"] = out.stdout.strip().splitlines()[device.index or 0] if out.returncode == 0 else None
        except (OSError, subprocess.TimeoutExpired, IndexError):
            info["nvidia_smi"] = None
    return info


def judge(readings: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """Each number compared beside its limit; correct when every limit the cell
    sets has a finite reading at or under it."""
    shown, ok = {}, True
    for name, limit in limits.items():
        value = readings.get(name)
        good = value is not None and math.isfinite(value) and value <= limit
        ok = ok and good
        shown[name] = {"value": value, "limit": limit}
    return ok, shown


def run_cell(p: Plan, seed: int, seconds: float, trace: bool, device, t_start: float,
             controls: Tuple[str, ...] = ()) -> Tuple[Dict[str, Any], List[str]]:
    """Set up, warm up, measure (or trace) the window, read the cell's
    metrics, free the program's state, then compare with the reference.
    Returns the result line's object and the check's lines for stderr.
    ``controls`` adds the control's readings at those precisions (the
    calibration's, not the benchmark's)."""
    run = Run(plan=p, seed=seed, seconds=seconds, trace=trace, device=device)
    run.driver = driver_module(p.traffic["kind"]).Driver(run)
    t_driver = time.perf_counter()
    run.driver.setup()
    if trace:
        from portbench import tracing

        tracing.warm(device)
    run.setup_s = time.perf_counter() - t_start - run.driver.reference_s
    if trace:
        run.window, run.traced = tracing.traced(
            lambda: measure(run.driver, seconds, device, int(p.traffic["trace_requests"])))
    else:
        run.window = measure(run.driver, seconds, device)
    card = card_info(device)
    metrics = {}
    for m in p.metrics:
        if (m in p.manifest.get("per_layer", [])) != trace:
            continue
        value = metric_reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    run.driver.release()
    readings = run.driver.check()
    correct, shown = judge(readings, p.limits)
    shown["failed_requests"] = {"value": run.window["failed"], "limit": 0}
    correct = correct and run.window["failed"] == 0
    device_obj = {"platform": card["platform"], "kind": card["kind"], "count": p.chips,
                  "memory_peak_bytes": run.window["peak_bytes"]}
    result: Dict[str, Any] = {"correct": correct, "attempted": run.window["attempted"],
                              "failed": run.window["failed"], "metrics": metrics, "device": device_obj}
    if run.traced is not None:
        device_obj["busy_s"] = run.traced["busy_s"]
        device_obj["window_s"] = run.traced["window_s"]
        result["breakdown"] = {"device_ops": run.traced["device_ops"], "idle_gaps": run.traced["idle_gaps"]}
    result["card"] = {"nvidia_smi": card.get("nvidia_smi"), "setup_s": run.setup_s,
                      "to_driver_setup_s": t_driver - t_start, "reference_setup_s": run.driver.reference_s, "window_s": run.window["seconds"],
                      "counts": run.window["counts"]}
    for name in controls:
        result.setdefault("controls", {})[name] = run.driver.check(control=name)
    result["check"] = shown
    return result, [f"check {name} {v['value']!r} limit {v['limit']!r}" for name, v in shown.items()]
