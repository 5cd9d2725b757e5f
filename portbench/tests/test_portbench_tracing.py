"""The reduction of a device trace to busy and window seconds, the top
device operations and the idle gaps named by the host's innermost event, on
a trace written by hand."""

from __future__ import annotations

import pytest

from portbench.tracing import WINDOW, summarize


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_summarize_by_hand():
    trace = {"traceEvents": [
        ev(WINDOW, "user_annotation", 100.0, 100.0),
        ev(WINDOW, "gpu_user_annotation", 100.0, 100.0),  # the device's copy of the annotation is no operation
        ev("k1", "kernel", 90.0, 30.0),    # clipped to [100, 120]
        ev("k2", "kernel", 110.0, 20.0),   # overlaps k1: the union is [100, 130]
        ev("copy", "gpu_memcpy", 150.0, 10.0),
        ev("k1", "kernel", 190.0, 20.0),   # clipped to [190, 200]
        ev("aten::mul", "cpu_op", 125.0, 30.0),
        ev("cudaLaunchKernel", "cuda_runtime", 138.0, 4.0),  # innermost at the gap [130, 150]'s middle
        ev("aten::add", "cpu_op", 160.0, 40.0),
    ]}
    out = summarize(trace)
    assert out["window_s"] == pytest.approx(100e-6)
    assert out["busy_s"] == pytest.approx(50e-6)
    assert out["device_ops"] == [["k1", pytest.approx(30e-6)], ["k2", pytest.approx(20e-6)],
                                 ["copy", pytest.approx(10e-6)]]
    assert dict(out["idle_gaps"]) == {"cudaLaunchKernel": pytest.approx(20e-6), "aten::add": pytest.approx(30e-6)}


def test_a_trace_without_device_work_is_refused():
    with pytest.raises(RuntimeError):
        summarize({"traceEvents": [ev(WINDOW, "user_annotation", 0.0, 10.0), ev("aten::mul", "cpu_op", 1.0, 2.0)]})


def test_readers_on_a_run_by_hand():
    from types import SimpleNamespace

    from portbench import core

    per = {"chain_steps": 250e9, "images": 90e9}
    run = SimpleNamespace(traced={"window_s": 2.0, "busy_s": 1.5}, dtype="float32", setup_s=9.5,
                          window={"counts": {"chain_steps": 400}, "seconds": 4.0, "peak_bytes": 3 * 2 ** 30},
                          driver=SimpleNamespace(flops_per=lambda unit: per.get(unit)))
    read = {name: core.metric_reader(name).read(run) for name in
            ("mfu.attr", "mfu.gen", "idle_share.attr", "chain_steps_per_s", "images_per_s", "peak_mem_gib",
             "setup_s")}
    assert read["mfu.attr"] == pytest.approx(100 * 400 * 250e9 / 2.0 / 165e12)
    assert read["mfu.gen"] is None and read["images_per_s"] is None  # nothing of theirs to read
    assert read["idle_share.attr"] == pytest.approx(25.0)
    assert read["chain_steps_per_s"] == pytest.approx(100.0)
    assert read["peak_mem_gib"] == pytest.approx(3.0) and read["setup_s"] == 9.5
