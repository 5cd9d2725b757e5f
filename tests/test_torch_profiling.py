"""The port's ``utils/profiling.py`` against the reference package's on the
CPU: the report's keys and counts, the formatted report's layout, the Chrome
trace, and ``cli.attribute --profile``'s four phases.
"""

import json
import os

import pytest
import torch

from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.utils import profiling as jprof
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.cli import (
    attribute as cli_attribute,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.utils import profiling as prof

TIMES = {"build_pipeline": [0.7], "generate_targets": [0.25], "solve_chunk": [1.5, 0.5, 2.0],
         "train_encoder": [3.25]}


@pytest.fixture
def clean_phases():
    prof.report(reset=True)
    jprof.report(reset=True)
    yield
    prof.report(reset=True)
    jprof.report(reset=True)


def test_report_keys_counts_and_layout_match_the_reference(clean_phases):
    for mod in (prof, jprof):
        for name, times in TIMES.items():
            mod._PHASES[name].extend(times)
    got, want = prof.report(), jprof.report()
    assert got == want  # the same keys, counts and statistics of the same times
    assert {k: v["count"] for k, v in got.items()} == {k: len(v) for k, v in TIMES.items()}
    assert prof.format_report(reset=True) == jprof.format_report(reset=True)
    assert prof.report() == {} and jprof.report() == {}


def test_phases_count_and_device_phase_fences_cpu_tensors(clean_phases):
    for _ in range(2):
        with prof.phase("a"):
            pass
    with prof.device_phase("b") as box:
        box.append({"x": torch.ones(3), "y": [torch.zeros(2)]})
    prof.fence(torch.ones(1))  # a CPU tensor is ready: nothing to wait for
    rep = prof.report()
    assert {k: v["count"] for k, v in rep.items()} == {"a": 2, "b": 1}
    assert set(rep["a"]) == {"count", "total_s", "mean_s", "min_s", "max_s"}


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    with prof.trace(str(tmp_path), "cpu"):
        torch.nn.functional.conv2d(torch.ones(1, 3, 8, 8), torch.ones(4, 3, 3, 3))
    (path,) = tmp_path.iterdir()
    events = json.load(open(path))["traceEvents"]
    assert any("conv" in e.get("name", "") for e in events)


def test_cli_attribute_profile_reports_the_four_phases(tmp_path, capsys, clean_phases):
    r = cli_attribute.run([
        "--device", "cpu", "--random_init", "--img_size", "16", "--style_dim", "16", "--n_mlp", "1",
        "--channel_max", "16", "--key_len", "4", "--shift", "8", "--loss", "mse", "--sample_size", "2",
        "--n", "2", "--steps", "2", "--init", "encoder", "--encoder_steps", "2", "--encoder_batch", "2",
        "--profile", "--save_dir", str(tmp_path)])
    out = capsys.readouterr().out
    report = out[out.index("[attribute] phase report:"):].splitlines()[1:]
    assert report[0] == jprof.format_report().splitlines()[0]  # the reference's header
    assert sorted(line.split()[0] for line in report[1:]) == [
        "build_pipeline", "generate_targets", "solve_chunk", "train_encoder"]
    assert all(line.split()[1] == "1" for line in report[1:])
    assert prof.report() == {}  # --profile prints the report with reset=True
    assert len(os.listdir(os.path.join(r.run_dir, "trace"))) == 1
