#!/usr/bin/env python3
"""Where the time of one training step of the PyTorch port goes, on one CUDA GPU.

    python3 tools/train_step_profile.py [--img_size 64] [--channel_max 128] [--steps 96] [--out FILE]

The model and recipe are ``cli.train``'s defaults (StyleGAN2 at 64 px,
channel_max 128, style_dim 512, n_mlp 8, batch 16, lazy R1 every 16 steps,
synthetic reals), the recipe the quality studies train.  After 32 warm-up
steps it measures, each over ``--steps`` steps (a multiple of 16, so each
holds its share of R1 steps):

- the wall time a step of ``training.gan.run_steps``, host clock around a
  ``torch.cuda.synchronize()``, as ``cli.train`` runs it;
- the host time a step of ``draw_step`` alone (the step's draws, synthetic
  reals included), then synchronized;
- under ``torch.profiler`` (16 steps, 1 with R1): the device time a step, the
  sum of the CUDA kernels' self times, by kernel name and grouped as
  ``chip_smoke.py``'s training phase groups them; the CUDA kernels launched a
  step; and the port's own kernels' launches a step (``ops/_cuda.py``'s
  counts).

The idle share is 1 - device time / wall time (the unprofiled wall).  Every
result is one JSON line; the card's name and power limit are on it.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
P = "attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--img_size", type=int, default=64)
    ap.add_argument("--channel_max", type=int, default=128)
    ap.add_argument("--steps", type=int, default=96)
    ap.add_argument("--out", default=None, help="also append the JSON line to this file")
    args = ap.parse_args()

    import torch
    from importlib import import_module
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("train_step_profile: needs a CUDA device", file=sys.stderr)
        return 2
    C = import_module(f"{P}.config")
    gan = import_module(f"{P}.training.gan")
    cuda_mod = import_module(f"{P}.ops._cuda")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]

    mcfg = C.ModelConfig(model="sg2", img_size=args.img_size, style_dim=512, n_mlp=8,
                         channel_max=args.channel_max, channel_multiplier=2, ckpt=None)
    tcfg = gan.TrainConfig(batch=16, d_reg_every=16)
    n = max(16, args.steps // 16 * 16)
    seed = 0
    state = gan.init_train_state(mcfg, tcfg, torch.Generator().manual_seed(seed), "cuda")
    gan.run_steps(state, seed, 32, mcfg, tcfg)  # warm-up: every kernel built, cuDNN's choices made

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = gan.run_steps(state, seed, n, mcfg, tcfg)  # ends in a host sync
    wall_ms = (time.perf_counter() - t0) * 1e3 / n

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for j in range(n):
        gan.draw_step(seed, state.step + j, mcfg, tcfg, "cuda")
    torch.cuda.synchronize()
    draw_ms = (time.perf_counter() - t0) * 1e3 / n

    cuda_mod.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        gan.run_steps(state, seed, 16, mcfg, tcfg)
        torch.cuda.synchronize()
    port_launches = {k: v / 16 for k, v in cuda_mod.launch_counts().items() if v}
    by_name, launches = {}, 0
    for e in prof.key_averages():
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = getattr(e, "self_cuda_time_total", 0.0)
        if dev > 0 and str(getattr(e, "device_type", "")).endswith("CUDA"):
            by_name[e.key] = by_name.get(e.key, 0.0) + dev / 1e3 / 16
            launches += e.count
    busy_ms = sum(by_name.values())
    groups = {}
    for k, v in by_name.items():
        g = next((m for m in ("upblur4_adj", "upblur4", "blur4") if m in k), None)
        if g is None:
            g = ("cudnn_cublas" if any(w in k for w in ("cudnn", "xmma", "convolve", "grad_engine", "gemm")) else
                 "pytorch_elementwise_reduce" if "at::native" in k else "other")
        groups[g] = groups.get(g, 0.0) + v
    finite = all(v == v and abs(v) < float("inf") for r in rows.values() for v in r)
    line = {"tool": "train_step_profile", "img_size": args.img_size, "channel_max": args.channel_max,
            "style_dim": 512, "n_mlp": 8, "batch": 16, "d_reg_every": 16, "steps_timed": n,
            "wall_ms_per_step": wall_ms, "steps_per_s": 1e3 / wall_ms, "draw_host_ms_per_step": draw_ms,
            "device_busy_ms_per_step": busy_ms, "idle_share": 1.0 - busy_ms / wall_ms,
            "cuda_kernels_per_step": launches / 16, "port_launches_per_step": port_launches,
            "device_ms_per_step_by_group": groups,
            "top_device_ms_per_step": dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:15]),
            "losses_finite": finite, "gpu": gpu}
    print(json.dumps(line), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(line) + "\n")
    return 0 if finite else 1


if __name__ == "__main__":
    sys.exit(main())
