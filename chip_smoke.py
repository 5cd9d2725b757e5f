#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA GPU.

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure raises and exits non-zero):

1. device   -- the card's name and power limit (nvidia-smi); build the
               CUDA kernels from ``<port>/csrc`` and time the build.
2. kernels  -- every kernel against its plain PyTorch version at the 256px
               main path's shapes (batch 2, float32, TF32 off): forward and
               dx within 1e-4 * max(1, max|plain|) (another summation order
               over up to 9*512 terms), and median CUDA-event times of both.
3. recovery -- planted keys recovered through the kernels on a tiny
               generator (32px, mse loss, 300 steps, 4 restarts, 3 samples).
4. generate -- ``cli.generate`` at full width (256px, style_dim 512, n_mlp 8,
               channel_max 512) writes its PNGs.
5. attribute-- ``cli.attribute`` at full width with the perceptual loss
               (2 samples x 4 restarts, 20 steps); every kernel's launch
               count over this run must be > 0.

Then it prints the card's name and power limit, one JSON line describing
each kernel, and, last, ``{"ok": true, "device": {...}}``.  Without a CUDA
device, or without the port's package beside it, it exits non-zero at once.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PORT = "attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch"
OUT = os.path.join(ROOT, "chiprun_out", "chip_smoke")
TOL = 1e-4
# the tiny converging configuration of the reference's end-to-end test
TINY = dict(img_size=32, style_dim=64, n_mlp=3, channel_max=64)
TINY_SEED = 1


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def median_ms(torch, fn, reps: int = 15, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def compare(torch, kernel_fn, plain_fn, x, cot):
    """Forward and dx of ``kernel_fn`` vs ``plain_fn`` on x; times of both."""
    xr = x.detach().requires_grad_(True)
    yk = kernel_fn(xr)
    (dk,) = torch.autograd.grad(yk, xr, cot, retain_graph=True)
    yp = plain_fn(xr)
    (dp,) = torch.autograd.grad(yp, xr, cot, retain_graph=True)
    torch.cuda.synchronize()
    errs = {}
    for name, k, p in (("fwd", yk, yp), ("dx", dk, dp)):
        err = (k - p).abs().max().item()
        scale = max(1.0, p.abs().max().item())
        check(bool(torch.isfinite(k).all()), f"non-finite {name}")
        check(err <= TOL * scale, f"{name} error {err:.3e} > {TOL} * {scale:.3e}")
        errs[name] = err
    with torch.no_grad():
        t = {
            "ms_fwd": median_ms(torch, lambda: kernel_fn(x)),
            "plain_ms_fwd": median_ms(torch, lambda: plain_fn(x)),
        }
    t["ms_bwd"] = median_ms(torch, lambda: torch.autograd.grad(yk, xr, cot, retain_graph=True))
    t["plain_ms_bwd"] = median_ms(torch, lambda: torch.autograd.grad(yp, xr, cot, retain_graph=True))
    return errs, t


def phase_kernels(torch, mods):
    up_cuda, vgg_cuda, slice_cuda, upf = mods
    g = torch.Generator().manual_seed(0)
    dev = "cuda"

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(dev)

    k1 = upf.split_symmetric_4tap(upf.make_kernel((1, 3, 3, 1)) * 4.0)
    cases = []
    for c, h2 in ((512, 8), (512, 16), (512, 32), (512, 64), (256, 128), (128, 256)):
        cases.append(("blur4", f"C{c}_H{h2}",
                      lambda v: up_cuda.blur4(v, k1, k1, (1, 1), (1, 1)),
                      lambda v: up_cuda.blur4_plain(v, k1, k1, (1, 1), (1, 1)),
                      rnd(2, h2 + 1, h2 + 1, c), rnd(2, h2, h2, c)))
    for h in (4, 8, 16, 32, 64, 128):
        cases.append(("upblur4", f"C3_H{h}", lambda v: up_cuda.upblur4(v, k1),
                      lambda v: up_cuda.upblur4_plain(v, k1), rnd(2, h, h, 3), rnd(2, 2 * h, 2 * h, 3)))
    for c, h in ((128, 128), (256, 64), (512, 32), (512, 16)):
        w, b = rnd(3, 3, c, c, scale=(2.0 / (9 * c)) ** 0.5), rnd(c, scale=0.1)
        cases.append(("conv3x3_relu", f"C{c}_H{h}",
                      lambda v, w=w, b=b: vgg_cuda.conv3x3_relu(v, w, b),
                      lambda v, w=w, b=b: vgg_cuda.conv3x3_relu_plain(v, w, b),
                      rnd(2, h, h, c), rnd(2, h, h, c)))
    ws = (rnd(3, 3, 3, 64, scale=(2.0 / 27) ** 0.5), rnd(64, scale=0.1),
          rnd(3, 3, 64, 64, scale=(2.0 / 576) ** 0.5), rnd(64, scale=0.1))
    cases.append(("vgg_slice1", "C3_H256", lambda v: slice_cuda.vgg_slice1(v, *ws),
                  lambda v: slice_cuda.vgg_slice1_plain(v, *ws),
                  rnd(2, 256, 256, 3), rnd(2, 256, 256, 64)))

    per_kernel = {}
    for name, shape, kfn, pfn, x, cot in cases:
        errs, t = compare(torch, kfn, pfn, x, cot)
        emit({"phase": "kernels", "kernel": name, "shape": shape, "batch": 2,
              "max_abs_err_fwd": errs["fwd"], "max_abs_err_dx": errs["dx"], **t})
        agg = per_kernel.setdefault(name, {"err_fwd": 0.0, "err_dx": 0.0, "ms_fwd": 0.0,
                                           "plain_ms_fwd": 0.0, "ms_bwd": 0.0, "plain_ms_bwd": 0.0})
        agg["err_fwd"] = max(agg["err_fwd"], errs["fwd"])
        agg["err_dx"] = max(agg["err_dx"], errs["dx"])
        for key in ("ms_fwd", "plain_ms_fwd", "ms_bwd", "plain_ms_bwd"):
            agg[key] += t[key]
    return per_kernel


def phase_recovery(torch, port):
    C, pl, attr = port["config"], port["pipeline"], port["attribute"]
    mcfg = C.ModelConfig(**TINY)
    fpcfg = C.FingerprintConfig(key_len=8, shift=56, n_pca_samples=2000)
    acfg = C.AttributionConfig(steps=300, n_starts=4, lr=0.2, loss="mse")
    pipe = pl.build_pipeline(mcfg, fpcfg, generator=torch.Generator().manual_seed(TINY_SEED),
                             device="cuda", want_lpips=False)
    imgs, _, _, bits, _ = pl.generate_fingerprinted(pipe, 3, torch.Generator().manual_seed(TINY_SEED + 1))
    t0 = time.time()
    res = attr.attribute(pipe.gen_params, None, pipe.basis, pipe.noise, imgs, mcfg=mcfg, acfg=acfg,
                         generator=torch.Generator().manual_seed(TINY_SEED + 2))
    torch.cuda.synchronize()
    ev = attr.evaluate_attribution(res, bits)
    accs = [float(a) for a in ev["bit_acc"].cpu()]
    emit({"phase": "recovery", "bit_acc": accs, "mean_bit_acc": sum(accs) / 3,
          "exact": sum(a >= 1.0 for a in accs), "loss": [float(v) for v in res.loss.cpu()],
          "seconds": time.time() - t0})
    check(sum(accs) / 3 > 0.85, f"mean bit accuracy {sum(accs) / 3:.3f} <= 0.85")
    check(sum(a >= 1.0 for a in accs) >= 2, f"fewer than 2 of 3 keys exact: {accs}")


FULL = ["--device", "cuda", "--random_init", "--img_size", "256", "--key_len", "64", "--shift", "448"]


def phase_generate(torch, port):
    from PIL import Image
    import numpy as np

    save = os.path.join(OUT, "generate")
    t0 = time.time()
    rc = port["cli_generate"].main(FULL + ["--sample_size", "4", "--save_dir", save])
    check(rc == 0, f"cli.generate returned {rc}")
    pngs = {}
    for dirpath, _, files in os.walk(save):
        for f in files:
            if f.endswith(".png"):
                pngs.setdefault(os.path.basename(dirpath), []).append(os.path.join(dirpath, f))
    check(set(pngs) == {"original", "watermarked", "watermark_pos", "watermark_neg"},
          f"PNG folders {sorted(pngs)}")
    for folder in ("original", "watermarked"):
        check(len(pngs[folder]) == 4, f"{folder}: {len(pngs[folder])} PNGs")
        for p in pngs[folder]:
            a = np.asarray(Image.open(p))
            check(a.shape == (256, 256, 3), f"{p}: shape {a.shape}")
            check(a.std() > 1.0, f"{p}: flat image")
    emit({"phase": "generate", "pngs": sum(len(v) for v in pngs.values()), "seconds": time.time() - t0})


def phase_attribute(torch, port, gpu):
    cuda_mod = port["_cuda"]
    save = os.path.join(OUT, "attribute")
    steps, samples, starts = 20, 2, 4
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_mod.reset_launches()
    r = port["cli_attribute"].run(FULL + ["--loss", "perceptual", "--sample_size", str(samples),
                                          "--n", str(starts), "--steps", str(steps),
                                          "--save_dir", save])
    counts = cuda_mod.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    for f in ("result.txt", "sampling_config.yaml"):
        check(os.path.exists(os.path.join(r.run_dir, f)), f"missing {f}")
    check(all(v == v and abs(v) < float("inf") for v in r.losses), f"non-finite losses {r.losses}")
    check(len(r.bit_accs) == samples, "result rows")
    for name, n in counts.items():
        check(n > 0, f"kernel {name} was not launched by the main path")
    emit({"phase": "attribute", "img_size": 256, "style_dim": 512, "n_mlp": 8, "channel_max": 512,
          "loss": "perceptual", "samples": samples, "restarts": starts, "steps": steps,
          "solve_seconds": r.solve_seconds, "steps_per_s": steps / r.solve_seconds,
          "chain_steps_per_s": steps * r.chains / r.solve_seconds,
          "max_memory_allocated_bytes": peak, "losses": r.losses, "bit_acc": r.bit_accs,
          "launches": counts, "gpu": gpu})
    return counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False); "
              "this smoke test runs only on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import importlib

        port = {name: importlib.import_module(f"{PORT}.{mod}") for name, mod in (
            ("_cuda", "ops._cuda"), ("up_cuda", "ops.upfirdn2d_cuda"), ("vgg_cuda", "ops.vgg_cuda"),
            ("slice_cuda", "ops.vgg_slice_cuda"), ("upf", "ops.upfirdn2d"), ("config", "config"),
            ("pipeline", "fingerprint.pipeline"), ("attribute", "fingerprint.attribute"),
            ("cli_generate", "cli.generate"), ("cli_attribute", "cli.attribute"))}
    except ImportError as e:
        print(f"chip_smoke: the port's package is not beside this script ({e})", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    os.makedirs(OUT, exist_ok=True)

    gpu = gpu_name_and_power()
    t0 = time.time()
    lib = port["_cuda"].build()
    port["_cuda"].library()
    emit({"phase": "device", "gpu": gpu, "torch": torch.__version__, "cuda": torch.version.cuda,
          "library": os.path.relpath(str(lib), ROOT), "build_seconds": time.time() - t0})

    per_kernel = phase_kernels(torch, (port["up_cuda"], port["vgg_cuda"], port["slice_cuda"], port["upf"]))
    phase_recovery(torch, port)
    phase_generate(torch, port)
    counts = phase_attribute(torch, port, gpu)

    kernels = []
    for name, k in port["_cuda"].KERNELS.items():
        base = "vgg_slice1" if name.startswith("vgg_slice1") else name
        agg = per_kernel[base]
        bwd = name == "vgg_slice1_bwd"
        kernels.append({
            "name": name, "route": "cuda", "source": f"{PORT}/{k.source}", "replaces": k.replaces,
            "launches": counts[name],
            "max_abs_err": agg["err_dx"] if bwd else max(agg["err_fwd"], agg["err_dx"]),
            "ms": agg["ms_bwd"] if bwd else agg["ms_fwd"],
            "plain_ms": agg["plain_ms_bwd"] if bwd else agg["plain_ms_fwd"],
        })
    print(gpu, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
