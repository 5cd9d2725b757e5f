"""The BigGAN attribution cell at a size a CPU test run holds: a sound run is
correct and counts one rendered image a chain-step, the tf32 control fails,
planted faults of the port's generator fail, and a port without the cell's
published configuration fails at set-up, before the reference's work.

The tiny configuration keeps the 512 table's structure (14 layers, attention
before layer 8, the last two at one channel multiple; four upsamplings, so
64px) at a truncation between two stored statistics rows.  The port's
normal path takes its configuration from ``BigGANConfig.for_size``, which
knows the published sizes only: the tests hand it the tiny one."""

from __future__ import annotations

import importlib
import json
import time

import pytest
import torch

from portbench import core
from portbench.core import PORT, judge
from portbench.tests.tiny import ATTR, LIMITS

BG_LAYERS = [[up and i in (7, 9, 11, 13), i_m, o_m] for i, (up, i_m, o_m) in enumerate(
    [[False, 16, 16], [True, 16, 16], [False, 16, 16], [True, 16, 8], [False, 8, 8], [True, 8, 8], [False, 8, 8],
     [True, 8, 4], [False, 4, 4], [True, 4, 2], [False, 2, 2], [True, 2, 1], [False, 1, 1], [True, 1, 1]])]
TINY_BG = dict(model="biggan", img_size=64, z_dim=16, class_embed_dim=8, channel_width=8, num_classes=10, n_stats=51,
               eps=1e-4, attention_layer_position=8, layers=BG_LAYERS, truncation=0.373, perceptual="lpips_vgg16",
               key_len=4, shift=8, sigma=1.0, sd_moved=1.0, n_pca_samples=256, **{"class": 3})
CELL = "biggan_deep_512.attr_f32"


def _bg():
    return importlib.import_module(f"{PORT}.models.biggan")


@pytest.fixture
def tiny_size(monkeypatch):
    bg = _bg()
    cfg = bg.BigGANConfig(z_dim=16, class_embed_dim=8, channel_width=8, num_classes=10, output_dim=64,
                          attention_layer_position=8, layers=tuple(tuple(t) for t in BG_LAYERS), n_stats=51)
    real = bg.BigGANConfig.for_size
    monkeypatch.setattr(bg.BigGANConfig, "for_size", classmethod(lambda cls, size: cfg if size == 64 else real(size)))


def run_tiny_biggan(controls=(), **traffic):
    manifest = json.loads((core.REPO / "BENCHMARK.json").read_text())
    tp = dict(ATTR, kind="attribute_biggan", **traffic)
    plan = core.Plan(cell=CELL, chips=1, config=dict(TINY_BG), traffic=tp, limits=dict(LIMITS["attribute"]),
                     metrics=core.cell_metrics(manifest, CELL, False), manifest=manifest)
    return core.run_cell(plan, 2 ** 31 + 17, 0.0, False, torch.device("cpu"), time.perf_counter(), controls)


def test_sound_run_is_correct_and_counts_its_images(tiny_size):
    result, _ = run_tiny_biggan()
    assert result["correct"], result["check"]
    counts = result["card"]["counts"]
    assert counts["chain_steps"] == counts["biggan_images"] == ATTR["solver"]["steps"] * ATTR["solver"]["n_starts"]


def test_control_fails(tiny_size):
    result, _ = run_tiny_biggan(controls=("tf32",))
    assert result["correct"]
    ok, shown = judge(result["controls"]["tf32"], LIMITS["attribute"])
    assert not ok, shown


def _attention_skipped(bg, monkeypatch):
    monkeypatch.setattr(bg, "self_attention", lambda x, p: x)


def _blend_swapped(bg, monkeypatch):
    def _interp_stats(stats, truncation, n_stats):
        pos = truncation * (n_stats - 1)
        lo = int(pos)
        return stats[lo] * (1.0 - (pos - lo)) + stats[lo + 1] * (pos - lo)

    monkeypatch.setattr(bg, "_interp_stats", _interp_stats)


@pytest.mark.parametrize("fault", [_attention_skipped, _blend_swapped])
def test_fault_is_caught(tiny_size, monkeypatch, fault):
    fault(_bg(), monkeypatch)
    result, _ = run_tiny_biggan()
    assert not result["correct"], result["check"]


def test_port_without_the_configuration_fails_at_set_up():
    """A port whose ``for_size`` does not know the cell's size (as one before
    BigGAN-deep-512) raises from ``build_pipeline``."""
    with pytest.raises(ValueError, match="published"):
        run_tiny_biggan()


def test_unfollowed_solver_settings_are_refused(tiny_size):
    with pytest.raises(core.SpecError):
        run_tiny_biggan(solver=dict(ATTR["solver"], polish_sweeps=1))


def test_b4_mix_is_the_f32_mix_with_four_targets():
    a, b = (json.loads((core.ROOT / "traffic" / f"{m}.json").read_text()) for m in ("attr_f32", "attr_f32_b4"))
    assert b.pop("targets_per_solve") == 4 and a.pop("targets_per_solve") == 1
    a.pop("about"), b.pop("about")
    assert a == b
