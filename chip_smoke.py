#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA GPU.

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure raises and exits non-zero):

1. device   -- the card's name and power limit (nvidia-smi); build the
               CUDA kernels from ``<port>/csrc`` and time the build.
2. kernels  -- every kernel against its plain PyTorch version at the 256px
               main path's shapes (batch 2, float32, TF32 off): forward and
               dx within 1e-4 * max(1, max|plain|) (another summation order
               over up to 9*512 terms; the tensor-core kernels sum three TF32
               products of split operands in the tensor cores' float32
               accumulators), and median CUDA-event times of both through
               autograd.  dx is autograd's on both sides; where the op ends
               in a ReLU the plain side takes the kernel's mask [y > 0] for
               it (two forwards that differ by rounding disagree on the mask
               where y is within rounding of zero), and the flips and the
               error under each side's own mask are printed beside it.
               Then every kernel's launch function alone at batch
               2 and at batch 16 (the 16-chain main path): its time, the plain
               version's, the time of the PyTorch call for the same function
               (``library_ms``), and the card's bound for the work
               (``ops/roofline.py``); conv3x3_relu (forward and dx) and the
               vgg_slice1 backward are held against plain again at batch 16.
3. recovery -- planted keys recovered through the kernels on a tiny
               generator (32px, mse loss, 300 steps, 4 restarts, 3 samples).
4. generate -- ``cli.generate`` at full width (256px, style_dim 512, n_mlp 8,
               channel_max 512) writes its PNGs.
5. attribute-- ``cli.attribute`` at full width with the perceptual loss
               (2 samples x 4 restarts, 20 steps); every kernel's launch
               count over this run must be > 0.  A second run of 10 steps
               gives the launches per solve step as the difference of the
               two runs' counts over the difference in steps.

Then it prints the card's name and power limit, one JSON line describing
each kernel, and, last, ``{"ok": true, "device": {...}}``.  Without a CUDA
device, or without the port's package beside it, it exits non-zero at once.
"""

from __future__ import annotations

import json
import os
import shutil
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


def compare(torch, kernel_fn, plain_fn, x, cot, masked_plain=None, keep=None):
    """Forward and dx (autograd on both sides) of ``kernel_fn`` vs ``plain_fn``
    on x; times of both.

    An op that ends in a ReLU masks its cotangent by [y > 0], and two forwards
    that differ by rounding disagree on that mask wherever y is within
    rounding of zero; each dx is then the exact gradient of its own forward.
    ``masked_plain(v, y)``, where given, is the plain version with its last
    ReLU replaced by the mask of the kernel's output ``y``: autograd then
    differentiates the plain arithmetic under the kernel's mask.  ``keep``, a
    mask over dx, leaves out the elements that an inner ReLU's sign within
    rounding of zero can move; they are counted and must stay under 1%.  The
    forward itself is held against plain with no mask at all."""
    xr = x.detach().requires_grad_(True)
    yk = kernel_fn(xr)
    (dk,) = torch.autograd.grad(yk, xr, cot, retain_graph=True)
    yp = plain_fn(xr)
    (dp,) = torch.autograd.grad(yp, xr, cot, retain_graph=True)
    dref = dp
    if masked_plain is not None:
        (dref,) = torch.autograd.grad(masked_plain(xr, yk.detach()), xr, cot)
    torch.cuda.synchronize()
    errs = {"dx_own_masks": (dk - dp).abs().max().item(),
            "mask_flips": int(((yk > 0) != (yp > 0)).sum().item()), "left_out": 0}
    if keep is not None:
        errs["left_out"] = int((~keep).sum().item())
        check(errs["left_out"] <= 0.01 * keep.numel(), f"{errs['left_out']} of {keep.numel()} dx values left out")
        dk, dref = dk * keep, dref * keep
    for name, k, p in (("fwd", yk, yp), ("dx", dk, dref)):
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


def conv1_sign_keep(torch, vgg_cuda, x, w1, b1):
    """Mask over the slice's dx [N, H, W, 3]: False in the 3x3 neighbourhoods of
    pixels where some channel of conv1(x) + b1 is within float32 rounding (1e-5)
    of zero.  The backward kernel recomputes that sign in another summation
    order than cuDNN's, so there the two [conv1 > 0] masks may differ."""
    import torch.nn.functional as F

    z1 = vgg_cuda.conv3x3_plain(x, w1, b1)
    near = (z1.abs().amin(dim=-1, keepdim=True) < 1e-5).float().permute(0, 3, 1, 2)
    near = F.max_pool2d(near, 3, stride=1, padding=1).permute(0, 2, 3, 1) > 0
    return ~near.expand(-1, -1, -1, 3)


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
                      rnd(2, h, h, c), rnd(2, h, h, c),
                      lambda v, y, w=w, b=b: vgg_cuda.conv3x3_plain(v, w, b) * (y > 0), None))
    ws = (rnd(3, 3, 3, 64, scale=(2.0 / 27) ** 0.5), rnd(64, scale=0.1),
          rnd(3, 3, 64, 64, scale=(2.0 / 576) ** 0.5), rnd(64, scale=0.1))

    def slice_masked_plain(v, y):
        a1 = torch.relu(vgg_cuda.conv3x3_plain(v, ws[0], ws[1]))
        return vgg_cuda.conv3x3_plain(a1, ws[2], ws[3]) * (y > 0)

    for label in ("C3_H256", "C3_H256_b", "C3_H256_c"):  # three draws: mask flips are rare events
        x = rnd(2, 256, 256, 3)
        cases.append(("vgg_slice1", label, lambda v: slice_cuda.vgg_slice1(v, *ws),
                      lambda v: slice_cuda.vgg_slice1_plain(v, *ws), x, rnd(2, 256, 256, 64),
                      slice_masked_plain, conv1_sign_keep(torch, vgg_cuda, x, ws[0], ws[1])))

    per_kernel = {}
    for name, shape, kfn, pfn, x, cot, *masks in cases:
        errs, t = compare(torch, kfn, pfn, x, cot, *masks)
        emit({"phase": "kernels", "kernel": name, "shape": shape, "batch": 2,
              "max_abs_err_fwd": errs["fwd"], "max_abs_err_dx": errs["dx"],
              "max_abs_err_dx_own_masks": errs["dx_own_masks"], "mask_flips": errs["mask_flips"],
              "left_out": errs["left_out"], **t})
        agg = per_kernel.setdefault(name, {"err_fwd": 0.0, "err_dx": 0.0, "ms_fwd": 0.0,
                                           "plain_ms_fwd": 0.0, "ms_bwd": 0.0, "plain_ms_bwd": 0.0})
        agg["err_fwd"] = max(agg["err_fwd"], errs["fwd"])
        agg["err_dx"] = max(agg["err_dx"], errs["dx"])
        for key in ("ms_fwd", "plain_ms_fwd", "ms_bwd", "plain_ms_bwd"):
            agg[key] += t[key]
    return per_kernel


def launch_cases(torch, mods, n, rnd):
    """Every main-path launch shape of every kernel at batch ``n``:
    (kernel, shape, kernel_fn, plain_fn, library_fn, counts, check), all on
    fixed inputs and without autograd.  ``library_fn`` is the PyTorch call
    that computes the same function; the port never calls it on the card.
    ``check`` is None or a function returning (kernel result, plain result,
    mask of elements to compare or None)."""
    import torch.nn.functional as F

    up_cuda, vgg_cuda, slice_cuda, upf, roof = mods
    k1 = upf.split_symmetric_4tap(upf.make_kernel((1, 3, 3, 1)) * 4.0)
    kt = torch.tensor(k1, device="cuda")
    cases = []

    def adjoint(ct, w):
        """conv3x3_plain's adjoint applied to ``ct``, by autograd (the conv is linear)."""
        with torch.enable_grad():
            x0 = torch.zeros_like(ct).requires_grad_(True)
            return torch.autograd.grad(vgg_cuda.conv3x3_plain(x0, w), x0, ct)[0]

    for c, h in roof.BLUR4_SHAPES:
        x = rnd(n, h + 1, h + 1, c)
        wl = torch.outer(kt, kt).flip(0, 1).expand(c, 1, 4, 4).contiguous()
        cases.append(("blur4", f"C{c}_H{h}", lambda x=x: up_cuda.blur4(x, k1, k1, (1, 1), (1, 1)),
                      lambda x=x: up_cuda.blur4_plain(x, k1, k1, (1, 1), (1, 1)),
                      lambda x=x, wl=wl, c=c: F.conv2d(x.permute(0, 3, 1, 2), wl, padding=1, groups=c),
                      roof.blur4(n, c, h, h), None))
    for h in roof.UPBLUR4_SHAPES:
        x = rnd(n, h, h, 3)
        wl = torch.outer(kt, kt).expand(3, 1, 4, 4).contiguous()
        cases.append(("upblur4", f"C3_H{h}", lambda x=x: up_cuda.upblur4(x, k1),
                      lambda x=x: up_cuda.upblur4_plain(x, k1),
                      lambda x=x, wl=wl: F.conv_transpose2d(x.permute(0, 3, 1, 2), wl, stride=2,
                                                            padding=1, groups=3),
                      roof.upblur4(n, 3, h, h), None))
    for c, h, _ in roof.CONV3X3_SHAPES:
        w, b = rnd(3, 3, c, c, scale=(2.0 / (9 * c)) ** 0.5), rnd(c, scale=0.1)
        x = rnd(n, h, h, c)
        # the adjoint taps (spatial flip, in/out swapped) for the TIMES of the plain and the
        # library call; the dx check below takes the adjoint from autograd instead
        wf = w.flip(0, 1).transpose(2, 3).contiguous()
        w_oihw, wf_oihw = (t.permute(3, 2, 0, 1).contiguous() for t in (w, wf))
        kf = lambda x=x, w=w, b=b: vgg_cuda.conv3x3_launch(x, w, b, relu=True)
        pf = lambda x=x, w=w, b=b: vgg_cuda.conv3x3_relu_plain(x, w, b)
        cases.append(("conv3x3_relu", f"C{c}_H{h}", kf, pf,
                      lambda x=x, wo=w_oihw, b=b: torch.relu(F.conv2d(x.permute(0, 3, 1, 2), wo, b, padding=1)),
                      roof.conv3x3(n, h, h, c), lambda kf=kf, pf=pf: (kf(), pf(), None)))
        kd = lambda x=x, w=w: vgg_cuda.conv3x3_launch(x, w, None, relu=False, flip=True)
        pd = lambda x=x, wf=wf: vgg_cuda.conv3x3_plain(x, wf)
        cases.append(("conv3x3_relu", f"C{c}_H{h}_dx", kd, pd,
                      lambda x=x, wo=wf_oihw: F.conv2d(x.permute(0, 3, 1, 2), wo, None, padding=1),
                      roof.conv3x3(n, h, h, c), lambda kd=kd, x=x, w=w: (kd(), adjoint(x, w), None)))
    ws = (rnd(3, 3, 3, 64, scale=(2.0 / 27) ** 0.5), rnd(64, scale=0.1),
          rnd(3, 3, 64, 64, scale=(2.0 / 576) ** 0.5), rnd(64, scale=0.1))
    hs = roof.SLICE1_H
    x, cot = rnd(n, hs, hs, 3), rnd(n, hs, hs, 64)
    cases.append(("vgg_slice1_fwd", f"C3_H{hs}", lambda: slice_cuda.slice1_forward_launch(x, *ws),
                  lambda: slice_cuda.vgg_slice1_plain(x, *ws), lambda: slice_cuda.vgg_slice1_plain(x, *ws),
                  roof.slice1_fwd(n, hs, hs), None))
    xr = x.detach().requires_grad_(True)
    with torch.enable_grad():
        yp = slice_cuda.vgg_slice1_plain(xr, *ws)
    a2 = yp.detach()

    def plain_bwd():
        return torch.autograd.grad(yp, xr, cot, retain_graph=True)[0]

    def kernel_bwd():
        return slice_cuda.slice1_backward_launch(cot, a2, x, ws[0], ws[1], ws[2])

    def check_bwd():
        # Both sides take the plain forward's a2.  conv1's sign is recomputed by the
        # kernel in another summation order than cuDNN's, so where |conv1(x) + b1| is
        # within float32 rounding of zero the two masks may differ: those pixels'
        # 3x3 neighbourhoods in dx are left out, and counted.
        return kernel_bwd(), plain_bwd(), conv1_sign_keep(torch, vgg_cuda, x, ws[0], ws[1])

    cases.append(("vgg_slice1_bwd", f"C3_H{hs}", kernel_bwd, plain_bwd, plain_bwd,
                  roof.slice1_bwd(n, hs, hs), check_bwd))
    return cases


def phase_launch_times(torch, mods, per_kernel):
    """Launch-only times at batch 2 and 16 beside bound, plain and library
    times; the batch-16 sums over a kernel's shapes go into ``per_kernel``."""
    roof = mods[-1]
    for n in (2, 16):
        g = torch.Generator().manual_seed(100 + n)

        def rnd(*shape, scale=1.0):
            return (torch.randn(shape, generator=g) * scale).to("cuda")

        with torch.no_grad():
            for name, shape, kfn, pfn, lfn, counts, chk in launch_cases(torch, mods, n, rnd):
                line = {"phase": "launch", "kernel": name, "shape": shape, "batch": n,
                        "ms": median_ms(torch, kfn), "plain_ms": median_ms(torch, pfn),
                        "library_ms": median_ms(torch, lfn), **counts}
                if chk is not None:
                    k, p, keep = chk()
                    torch.cuda.synchronize()
                    diff = (k - p).abs()
                    if keep is not None:
                        line["left_out"] = int((~keep).sum().item())
                        check(line["left_out"] <= 0.01 * keep.numel(),
                              f"{name} {shape}: {line['left_out']} of {keep.numel()} values left out")
                        diff = diff * keep
                    err, scale = diff.max().item(), max(1.0, p.abs().max().item())
                    check(bool(torch.isfinite(k).all()), f"{name} {shape}: non-finite result")
                    check(err <= TOL * scale,
                          f"{name} {shape} batch {n}: error {err:.3e} > {TOL} * {scale:.3e}")
                    line["max_abs_err"] = err
                emit(line)
                agg = per_kernel.setdefault(("launch", name), {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                                                               "bound_ms": 0.0, "bound_by": {}, "err": 0.0})
                agg["err"] = max(agg["err"], line.get("max_abs_err", 0.0))
                if n == 16 and not shape.endswith("_dx"):
                    for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
                        agg[key] += line[key]
                    by = agg["bound_by"]
                    by[line["bound_by"]] = by.get(line["bound_by"], 0.0) + line["bound_ms"]


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
    packs = port["tf32"].pack_count
    r = port["cli_attribute"].run(FULL + ["--loss", "perceptual", "--sample_size", str(samples),
                                          "--n", str(starts), "--steps", str(steps),
                                          "--save_dir", save])
    counts = cuda_mod.launch_counts()
    packs = port["tf32"].pack_count - packs
    peak = torch.cuda.max_memory_allocated()
    # the same run with half the steps: what a solve step launches is the difference
    cuda_mod.reset_launches()
    port["cli_attribute"].run(FULL + ["--loss", "perceptual", "--sample_size", str(samples),
                                      "--n", str(starts), "--steps", str(steps // 2),
                                      "--save_dir", save + "_half"])
    half = cuda_mod.launch_counts()
    per_step = {}
    for name, n in counts.items():
        d, m = divmod(n - half[name], steps - steps // 2)
        check(m == 0, f"kernel {name}: {n} and {half[name]} launches over {steps} and {steps // 2} steps")
        want = port["roof"].LAUNCHES_PER_STEP[name]
        check(d == want, f"kernel {name}: {d} launches per solve step, the bound's table expects {want}")
        per_step[name] = d
    for f in ("result.txt", "sampling_config.yaml"):
        check(os.path.exists(os.path.join(r.run_dir, f)), f"missing {f}")
    check(all(v == v and abs(v) < float("inf") for v in r.losses), f"non-finite losses {r.losses}")
    check(len(r.bit_accs) == samples, "result rows")
    for name, n in counts.items():
        check(n > 0, f"kernel {name} was not launched by the main path")
    # 8 square convs in two orientations + the slice's two adjoint convs, once each
    check(packs <= 18, f"{packs} weight packings over {steps} steps: weights are packed per call")
    emit({"phase": "attribute", "img_size": 256, "style_dim": 512, "n_mlp": 8, "channel_max": 512,
          "loss": "perceptual", "samples": samples, "restarts": starts, "steps": steps,
          "solve_seconds": r.solve_seconds, "steps_per_s": steps / r.solve_seconds,
          "chain_steps_per_s": steps * r.chains / r.solve_seconds,
          "max_memory_allocated_bytes": peak, "losses": r.losses, "bit_acc": r.bit_accs,
          "launches": counts, "launches_half_run": half, "launches_per_step": per_step,
          "weight_packings": packs, "gpu": gpu})
    return counts, per_step


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
            ("slice_cuda", "ops.vgg_slice_cuda"), ("upf", "ops.upfirdn2d"), ("roof", "ops.roofline"),
            ("tf32", "ops.tf32"), ("config", "config"),
            ("pipeline", "fingerprint.pipeline"), ("attribute", "fingerprint.attribute"),
            ("cli_generate", "cli.generate"), ("cli_attribute", "cli.attribute"))}
    except ImportError as e:
        print(f"chip_smoke: the port's package is not beside this script ({e})", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    shutil.rmtree(OUT, ignore_errors=True)  # an earlier run's PNGs would be counted with this run's
    os.makedirs(OUT, exist_ok=True)

    gpu = gpu_name_and_power()
    t0 = time.time()
    lib = port["_cuda"].build()
    port["_cuda"].library()
    emit({"phase": "device", "gpu": gpu, "torch": torch.__version__, "cuda": torch.version.cuda,
          "library": os.path.relpath(str(lib), ROOT), "build_seconds": time.time() - t0})

    mods = (port["up_cuda"], port["vgg_cuda"], port["slice_cuda"], port["upf"])
    per_kernel = phase_kernels(torch, mods)
    phase_launch_times(torch, mods + (port["roof"],), per_kernel)
    phase_recovery(torch, port)
    phase_generate(torch, port)
    counts, per_step = phase_attribute(torch, port, gpu)

    kernels = []
    for name, k in port["_cuda"].KERNELS.items():
        base = "vgg_slice1" if name.startswith("vgg_slice1") else name
        agg, launch = per_kernel[base], per_kernel[("launch", name)]
        bwd = name == "vgg_slice1_bwd"
        # times: one launch of each distinct main-path shape at batch 16 (the 16-chain
        # solve), launch function only, summed over the shapes
        kernels.append({
            "name": name, "route": "cuda", "source": f"{PORT}/{k.source}", "replaces": k.replaces,
            "launches": counts[name],
            "max_abs_err": max(launch["err"], agg["err_dx"] if bwd else agg["err_fwd"] if base != name
                               else max(agg["err_fwd"], agg["err_dx"])),
            "ms": launch["ms"], "plain_ms": launch["plain_ms"], "bound_ms": launch["bound_ms"],
            "bound_by": max(launch["bound_by"], key=launch["bound_by"].get),
            "library_ms": launch["library_ms"], "batch": 16,
            "launches_per_step": per_step[name],
        })
    print(gpu, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
