"""A cell at a size a CPU test run holds: every width of the configurations
cut, the same code paths."""

from __future__ import annotations

import json
import time

import torch

from portbench import core

TINY = dict(model="stylegan2", img_size=32, style_dim=32, n_mlp=2, channel_multiplier=2, channel_max=16, n_latent=8,
            lr_mlp=0.01, blur_kernel=[1, 3, 3, 1], perceptual="lpips_vgg16", key_len=4, shift=20, sigma=1.0,
            sd_moved=1.0, n_pca_samples=256)
ATTR = dict(kind="attribute", dtype="float32", targets_per_solve=1,
            solver=dict(steps=3, n_starts=3, lr=0.2, lr_decay=0.001, bound_weight=0.1, loss="perceptual"),
            remat=False, target_pool=2, init_pool=4, warm_steps=1, trace_requests=1, check_solves=2,
            ref_block=2)
GEN = dict(kind="generate", dtype="float32", batch=4, request_pool=4, warm_requests=1, trace_requests=2,
           check_requests=2, ref_block=2)
# Set from the CPU's readings on seeds 1000-1004: the port against the reference reads loss 8e-8 - 2.9e-7,
# gradient 1.7e-6 - 3.2e-4 (a kink of an activation flips at the tiny widths), Adam step 7.9e-8 - 1.2e-7,
# image 0 - 3.3e-4 levels; the tf32 control at least loss 2.7e-4, gradient 8.7e-3, Adam step 2.2e-4,
# image 4.3e-2 levels, the bfloat16 one more; a doubled rate decay reads an Adam step gap of 3.0e-3.
LIMITS = {"attribute": {"loss_gap": 1e-5, "grad_gap": 2e-3, "update_gap": 1e-5, "exact_mismatch": 0},
          "generate": {"embed_gap": 1e-5, "image_gap": 0.01}}
CELLS = {"attribute": "sg2_256.attr_f32", "generate": "sg2_256.gen_f32"}


def tiny_plan(kind: str) -> core.Plan:
    manifest = json.loads((core.REPO / "BENCHMARK.json").read_text())
    cell = CELLS[kind]
    return core.Plan(cell=cell, chips=1, config=dict(TINY), traffic=dict(ATTR if kind == "attribute" else GEN),
                     limits=dict(LIMITS[kind]), metrics=core.cell_metrics(manifest, cell, False), manifest=manifest)


def run_tiny(kind: str, seed: int = 2 ** 31 + 11, controls=(), device="cpu", **traffic):
    """A whole run of the tiny cell past the harness' look for a chip; ``traffic``
    replaces settings of its mix."""
    plan = tiny_plan(kind)
    plan.traffic.update(traffic)
    return core.run_cell(plan, seed, 0.0, False, torch.device(device), time.perf_counter(), controls)
