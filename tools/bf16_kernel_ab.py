#!/usr/bin/env python3
"""Time the port's redesigned bf16 kernels on one CUDA GPU, launch only,
beside their bound and the PyTorch library call for the same function.

    python3 tools/bf16_kernel_ab.py [--root TREE] [--batch 16] [--tag NAME] [--out FILE]
                                    [--only conv|slice|blur4]

``--root`` names the checkout whose port is timed (default: this one), so
that another commit, unpacked with ``git archive``, is timed by the same
code in the same call (run it in turns: parent, change, change, parent).
For each main-path shape (``ops/roofline.py``): ``conv3x3_relu_bf16``
forward (bias + ReLU) and its dx launch (the adjoint taps, no bias, no
ReLU), against ``F.conv2d`` (+ ReLU) in bf16; ``vgg_slice1_fwd_bf16`` and
``vgg_slice1_bwd_bf16`` at 256px against two cuDNN bf16 convs (+ ReLUs) and
autograd over them; ``blur4_bf16`` at the forward shapes
(``main_path("blur4")``) and the adjoint's (``main_path("blur4_adj")``,
summed as ``blur4_bf16_adj``) against the depthwise bf16 ``F.conv2d``.
CUDA events, median of 15 single launches after 3 warm-up launches (the
repo's launch-only time: the wrapper's host work is in it), and the mean of
20 launches enqueued back to back (``back_to_back_ms``: device time where the
kernel outlasts the wrapper's host work).  Each result is also
held against the kernel's plain bf16 version (max|err| / max|plain| < 0.03,
the slice backward outside conv1's sign neighbourhoods).  Every result is a
JSON line with the card's name and power limit; the last line sums the
batch's shapes per kernel.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

P = "attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch"
BF16_TOL = 0.03


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


def back_to_back_ms(torch, fn, reps: int = 20) -> float:
    """Mean time of ``reps`` launches enqueued back to back: the wrapper's host
    work overlaps the previous launch, so where the kernel is the longer of the
    two this is its device time."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=None, help="also append the JSON lines to this file")
    ap.add_argument("--only", choices=("conv", "slice", "blur4"), default=None, help="time one kernel's launches")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import torch
    import torch.nn.functional as F
    from importlib import import_module

    if not torch.cuda.is_available():
        print("bf16_kernel_ab: needs a CUDA device", file=sys.stderr)
        return 2
    roof = import_module(f"{P}.ops.roofline")
    vgg_cuda = import_module(f"{P}.ops.vgg_cuda")
    slice_cuda = import_module(f"{P}.ops.vgg_slice_cuda")
    up_cuda = import_module(f"{P}.ops.upfirdn2d_cuda")
    upf = import_module(f"{P}.ops.upfirdn2d")
    _cuda = import_module(f"{P}.ops._cuda")
    _cuda.build()
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    out = open(args.out, "a") if args.out else None

    def emit(obj):
        obj = {"tag": args.tag, "gpu": gpu, **obj}
        print(json.dumps(obj), flush=True)
        if out:
            out.write(json.dumps(obj) + "\n")

    gen = torch.Generator().manual_seed(300 + args.batch)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to("cuda")

    n, bf = args.batch, torch.bfloat16
    sums = {}

    def row(kernel, shape, kf, lf, bound, check):
        k, p, keep = check()
        torch.cuda.synchronize()
        diff = (k.float() - p.float()).abs()
        if keep is not None:
            diff = diff * keep
        err, pmax = diff.max().item(), p.float().abs().max().item()
        ok = bool(torch.isfinite(k).all()) and err < BF16_TOL * pmax
        line = {"kernel": kernel, "shape": shape, "batch": n, "ms": median_ms(torch, kf),
                "back_to_back_ms": back_to_back_ms(torch, kf), "library_ms": median_ms(torch, lf),
                "bound_ms": bound["bound_ms"],
                "bound_by": bound["bound_by"], "max_abs_err": err, "max_abs_plain": pmax, "ok": ok}
        line["share_of_bound"] = line["bound_ms"] / line["ms"]
        emit(line)
        s = sums.setdefault(kernel, {"ms": 0.0, "back_to_back_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0, "ok": True})
        for key in ("ms", "back_to_back_ms", "library_ms", "bound_ms"):
            s[key] += line[key]
        s["ok"] = s["ok"] and ok

    def summary():
        emit({"summary": {k: {**v, "share_of_bound": v["bound_ms"] / v["ms"]} for k, v in sums.items()},
              "root": os.path.abspath(args.root)})
        return 0 if all(v["ok"] for v in sums.values()) else 1

    with torch.no_grad():
        for c, h, _ in roof.CONV3X3_SHAPES if args.only in (None, "conv") else ():
            w, b = rnd(3, 3, c, c, scale=(2.0 / (9 * c)) ** 0.5), rnd(c, scale=0.1)
            x = rnd(n, h, h, c).to(bf)
            wf = w.flip(0, 1).transpose(2, 3).contiguous()
            wo, wfo = (t.permute(3, 2, 0, 1).contiguous().to(bf) for t in (w, wf))
            bound = roof.conv3x3(n, h, h, c, "bfloat16")
            kf = lambda x=x, w=w, b=b: vgg_cuda.conv3x3_launch(x, w, b, relu=True)
            row("conv3x3_relu_bf16", f"C{c}_H{h}", kf,
                lambda x=x, wo=wo, b=b.to(bf): torch.relu(F.conv2d(x.permute(0, 3, 1, 2), wo, b, padding=1)),
                bound, lambda kf=kf, x=x, w=w, b=b: (kf(), vgg_cuda.conv3x3_relu_plain(x, w, b), None))
            kd = lambda x=x, w=w: vgg_cuda.conv3x3_launch(x, w, None, relu=False, flip=True)
            row("conv3x3_relu_bf16_dx", f"C{c}_H{h}_dx", kd,
                lambda x=x, wfo=wfo: F.conv2d(x.permute(0, 3, 1, 2), wfo, None, padding=1),
                bound, lambda kd=kd, x=x, wf=wf: (kd(), vgg_cuda.conv3x3_plain(x, wf), None))
            del x
        if args.only in (None, "blur4"):
            k1 = upf.split_symmetric_4tap(upf.make_kernel((1, 3, 3, 1)) * 4.0)
            kt = torch.tensor(k1, device="cuda")
            counts = {**dict(roof.main_path("blur4", n, "bfloat16")), **dict(roof.main_path("blur4_adj", n, "bfloat16"))}
            for c, h in roof.BLUR4_SHAPES:
                # the forward launch (input h + 1, pads 1) takes the flipped taps, its adjoint
                # (input h, pads 3 - 1) the unflipped ones
                for kname, label, side, p, taps, k2 in (
                        ("blur4_bf16", f"C{c}_H{h}", h + 1, 1, k1[::-1], torch.outer(kt, kt).flip(0, 1)),
                        ("blur4_bf16_adj", f"C{c}_H{h}_adj", h, 2, k1, torch.outer(kt, kt))):
                    x = rnd(n, side, side, c).to(bf)
                    wl = k2.expand(c, 1, 4, 4).contiguous().to(bf)
                    kf = lambda x=x, t=taps, p=p: up_cuda.blur4_launch(x, t, t, (p, p), (p, p))
                    row(kname, label, kf,
                        lambda x=x, wl=wl, c=c, p=p: F.conv2d(x.permute(0, 3, 1, 2), wl, padding=p, groups=c),
                        counts[label],
                        lambda kf=kf, x=x, t=taps, p=p: (kf(), up_cuda.blur4_plain(x, t[::-1], t[::-1], (p, p), (p, p)),
                                                         None))
                    del x
        if args.only not in (None, "slice"):
            return summary()
        hs = roof.SLICE1_H
        ws = (rnd(3, 3, 3, 64, scale=(2.0 / 27) ** 0.5), rnd(64, scale=0.1),
              rnd(3, 3, 64, 64, scale=(2.0 / 576) ** 0.5), rnd(64, scale=0.1))
        x, cot = rnd(n, hs, hs, 3).to(bf), rnd(n, hs, hs, 64).to(bf)
        wl = [t.permute(3, 2, 0, 1).contiguous().to(bf) if t.dim() == 4 else t.to(bf) for t in ws]

        def library_slice(v):
            return torch.relu(F.conv2d(torch.relu(F.conv2d(v.permute(0, 3, 1, 2), wl[0], wl[1], padding=1)),
                                       wl[2], wl[3], padding=1))

        kf = lambda: slice_cuda.slice1_forward_launch(x, *ws)
        row("vgg_slice1_fwd_bf16", f"C3_H{hs}", kf, lambda: library_slice(x), roof.slice1_fwd(n, hs, hs, "bfloat16"),
            lambda: (kf(), slice_cuda.vgg_slice1_plain(x, *ws), None))
        xr, xl = x.detach().requires_grad_(True), x.detach().requires_grad_(True)
        with torch.enable_grad():
            yp, yl = slice_cuda.vgg_slice1_plain(xr, *ws), library_slice(xl)
        a2 = yp.detach()
        kb = lambda: slice_cuda.slice1_backward_launch(cot, a2, x, ws[0], ws[1], ws[2])

        def check_bwd():
            # conv1's sign neighbourhoods, where the kernel's fmaf order and cuDNN's sum may differ
            z1 = vgg_cuda.conv3x3_plain(x.float(), ws[0].to(bf).float(), ws[1])
            near = (z1.abs().amin(dim=-1, keepdim=True) < 1e-5).float().permute(0, 3, 1, 2)
            keep = ~(F.max_pool2d(near, 3, stride=1, padding=1).permute(0, 2, 3, 1) > 0)
            return kb(), torch.autograd.grad(yp, xr, cot, retain_graph=True)[0], keep

        row("vgg_slice1_bwd_bf16", f"C3_H{hs}", kb,
            lambda: torch.autograd.grad(yl, xl, cot.permute(0, 3, 1, 2), retain_graph=True)[0],
            roof.slice1_bwd(n, hs, hs, "bfloat16"), check_bwd)
    return summary()


if __name__ == "__main__":
    sys.exit(main())
