#!/usr/bin/env python3
"""Time the PyTorch port's 256px perceptual attribution step on one CUDA GPU,
with the hand-written kernels and with their plain PyTorch versions.

    python3 tools/torch_step_ab.py [--chains 16] [--steps 10] [--out FILE]

Full-width StyleGAN2 (256px, style_dim 512, n_mlp 8, channel_max 512) and
LPIPS-VGG16, random weights from a seed, ``--chains`` = 4 restarts x
(chains / 4) samples.  It runs the solver's own ``step`` in the turns
kernel, plain, plain, kernel (one card, one call: two versions compare only
so), each turn ``--steps`` steps after 3 warm-up steps, host clock around a
``torch.cuda.synchronize()``.  "Plain" swaps the four wrappers for their
plain versions by assignment in this script only; the port has no such
switch.  Then it profiles 3 steps with the kernels on (``torch.profiler``)
and prints the device time per step by kernel name, the device-busy time and
its complement in the (unprofiled) kernel turns' wall time, the idle share.  Every result is a JSON line; the card's
name and power limit are on each.
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
    ap.add_argument("--chains", type=int, default=16)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--out", default=None, help="also append the JSON lines to this file")
    args = ap.parse_args()

    import torch
    from importlib import import_module

    if not torch.cuda.is_available():
        print("torch_step_ab: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    C = import_module(f"{P}.config")
    pl = import_module(f"{P}.fingerprint.pipeline")
    attr = import_module(f"{P}.fingerprint.attribute")
    lp = import_module(f"{P}.losses.lpips")
    up_cuda = import_module(f"{P}.ops.upfirdn2d_cuda")
    vgg_cuda = import_module(f"{P}.ops.vgg_cuda")
    slice_cuda = import_module(f"{P}.ops.vgg_slice_cuda")
    lhs = import_module(f"{P}.utils.lhs")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]

    def emit(obj):
        line = json.dumps({**obj, "gpu": gpu})
        print(line, flush=True)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "a") as f:
                f.write(line + "\n")

    mcfg = C.ModelConfig(img_size=256)
    fpcfg = C.FingerprintConfig(key_len=64, shift=448)
    acfg = C.AttributionConfig(steps=args.steps, n_starts=4, loss="perceptual")
    samples = max(1, args.chains // 4)
    pipe = pl.build_pipeline(mcfg, fpcfg, generator=torch.Generator().manual_seed(0), device="cuda")
    imgs, *_ = pl.generate_fingerprinted(pipe, samples, torch.Generator().manual_seed(1))
    with torch.no_grad():
        feats = [f[:, None] for f in lp.extract_features(pipe.lpips_params, imgs)]
    step, _ = attr.make_attribution_step(pipe.gen_params, pipe.lpips_params, pipe.basis, pipe.noise,
                                         mcfg, acfg, feats, None)
    alpha0 = torch.as_tensor(lhs.lhs_alpha_init_batch(samples, 4, pipe.basis.sigma_rest,
                                                      torch.Generator().manual_seed(2)),
                             dtype=torch.float32).cuda()
    key0 = torch.zeros((samples, 4, 64), device="cuda")

    kernel_fns = {(up_cuda, "blur4"): up_cuda.blur4, (up_cuda, "upblur4"): up_cuda.upblur4,
                  (lp, "conv3x3_relu"): lp.conv3x3_relu, (lp, "vgg_slice1"): lp.vgg_slice1}
    plain_fns = {(up_cuda, "blur4"): up_cuda.blur4_plain, (up_cuda, "upblur4"): up_cuda.upblur4_plain,
                 (lp, "conv3x3_relu"): vgg_cuda.conv3x3_relu_plain,
                 (lp, "vgg_slice1"): slice_cuda.vgg_slice1_plain}

    def use(fns):
        for (mod, name), fn in fns.items():
            setattr(mod, name, fn)

    def run(n):
        state = attr.init_state(alpha0, key0)
        for _ in range(3):
            state, _ = step(state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            state, per = step(state)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3, float(per.mean())

    kernel_ms = []
    for turn, fns in enumerate((kernel_fns, plain_fns, plain_fns, kernel_fns)):
        use(fns)
        ms, loss = run(args.steps)
        if fns is kernel_fns:
            kernel_ms.append(ms)
        emit({"what": "step", "turn": turn, "mode": "kernel" if fns is kernel_fns else "plain",
              "chains": samples * 4, "ms_per_step": ms, "chain_steps_per_s": samples * 4 / ms * 1e3,
              "loss": loss, "peak_bytes": torch.cuda.max_memory_allocated()})

    use(kernel_fns)
    from torch.profiler import ProfilerActivity, profile

    state = attr.init_state(alpha0, key0)
    for _ in range(3):
        state, _ = step(state)
    torch.cuda.synchronize()
    nprof = 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(nprof):
            state, _ = step(state)
        torch.cuda.synchronize()
    wall = sum(kernel_ms) / len(kernel_ms)  # unprofiled: the profiler slows the host down
    rows = []
    for e in prof.key_averages():
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = getattr(e, "self_cuda_time_total", 0.0)
        if dev > 0 and str(getattr(e, "device_type", "")).endswith("CUDA"):
            rows.append((dev / 1e3 / nprof, e.key, e.count // nprof))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    emit({"what": "profile", "chains": samples * 4, "wall_ms_per_step": wall,
          "device_busy_ms_per_step": busy, "idle_share": max(0.0, 1.0 - busy / wall),
          "top": [{"ms_per_step": r[0], "share": r[0] / busy, "name": r[1][:120], "launches_per_step": r[2]}
                  for r in rows[:25]]})
    return 0


if __name__ == "__main__":
    sys.exit(main())
