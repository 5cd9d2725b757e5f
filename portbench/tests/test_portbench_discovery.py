"""``BENCHMARK.json`` and the files it names: every cell finds its
configuration, its mix, its request kind, its limits and a reader for each
of its metrics; names, units and keys keep to the benchmark's contract; every
cell takes one chip."""

from __future__ import annotations

import json
import re

import pytest

from portbench import core

MANIFEST = json.loads((core.REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MANIFEST["workloads"]]
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def test_manifest_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["command"][1] == "portbench/run.py" and MANIFEST["paths"] == ["portbench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"}}
    for section, allowed in keys.items():
        for entry in MANIFEST[section]:
            assert set(entry) <= allowed, entry
    assert any(m["name"] == "setup_s" for m in MANIFEST["end_to_end"])


def test_names_units_and_text():
    names = []
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in MANIFEST[section]:
            assert core.NAME.match(entry["name"]), entry["name"]
            names.append(entry["name"])
            for key in ("why", "layer", "source"):
                if key in entry:
                    assert TEXT.match(entry[key]), entry[key]
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
    assert len(names) == len(set(names))
    for m in MANIFEST["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("cell", CELLS)
def test_cell_finds_its_files(cell):
    plan = core.plan(cell, MANIFEST)
    assert plan.chips == 1
    assert core.driver_module(plan.traffic["kind"]).Driver
    for m in plan.metrics:
        assert callable(core.metric_reader(m["name"]).read)
    e2e = core.cell_metrics(MANIFEST, cell, False)
    per_layer = core.cell_metrics(MANIFEST, cell, True)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and per_layer
    assert {m["moves"] for m in per_layer} <= {m["name"] for m in e2e}
    config = next(w["config"] for w in MANIFEST["workloads"] if w["name"] == cell)
    entry = next(c for c in MANIFEST["configs"] if c["name"] == config)
    assert set(core.load_json(core.ROOT / "workloads" / f"{cell}.json")) == {"limits"}
    assert plan.limits and set(plan.config["reduced"]) == set(entry["reduced"])
    assert plan.config["source"] == entry["source"]


def test_every_config_is_used_and_its_file_is_under_paths():
    used = {w["config"] for w in MANIFEST["workloads"]}
    for c in MANIFEST["configs"]:
        assert c["name"] in used and c["file"] == f"portbench/configs/{c['name']}.json"
        assert (core.REPO / c["file"]).is_file()


def test_every_file_is_named_by_a_name():
    for kind, suffix in (("configs", ".json"), ("traffic", ".json"), ("workloads", ".json"), ("metrics", ".py")):
        for path in (core.ROOT / kind).iterdir():
            if path.name.startswith("_") or path.name == "__pycache__":
                continue
            assert path.name.endswith(suffix) and core.NAME.match(path.name[:-len(suffix)]), path


def test_unknown_names_are_refused():
    with pytest.raises(core.SpecError):
        core.plan("no_such.cell", MANIFEST)
    with pytest.raises(core.SpecError):
        core.metric_reader("no/such")
