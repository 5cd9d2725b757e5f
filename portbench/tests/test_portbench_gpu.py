"""On the card: a tiny cell traced end to end (the profiler's trace reduced to
busy and window seconds, the breakdown and the per-layer readers)."""

from __future__ import annotations

import pytest
import torch

from portbench import core
from portbench.tests.tiny import tiny_plan


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["attribute", "generate"])
def test_traced_tiny_cell(kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import json
    import time

    plan = tiny_plan(kind)
    manifest = json.loads((core.REPO / "BENCHMARK.json").read_text())
    plan.metrics = core.cell_metrics(manifest, plan.cell, True)
    result, _ = core.run_cell(plan, 2 ** 31 + 5, 0.0, True, torch.device("cuda", 0), time.perf_counter())
    assert result["correct"], result["check"]
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    assert result["breakdown"]["device_ops"] and len(result["breakdown"]["device_ops"]) <= 10
    for name, m in result["metrics"].items():
        assert 0 <= m["value"] <= 100, (name, m)
