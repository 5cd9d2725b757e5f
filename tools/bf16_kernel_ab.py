#!/usr/bin/env python3
"""Time the port's redesigned bf16 kernels on one CUDA GPU, launch only,
beside their bound and the PyTorch library call for the same function.

    python3 tools/bf16_kernel_ab.py [--root TREE] [--batch 16] [--tag NAME] [--out FILE]
                                    [--only conv|slice|blur4|upblur4|step]

``--root`` names the checkout whose port is timed (default: this one), so
that another commit, unpacked with ``git archive``, is timed by the same
code in the same call (run it in turns: parent, change, change, parent).
For each main-path shape (``ops/roofline.py``): ``conv3x3_relu_bf16``
forward (bias + ReLU) and its dx launch (the adjoint taps, no bias, no
ReLU), against ``F.conv2d`` (+ ReLU) in bf16; ``vgg_slice1_fwd_bf16`` and
``vgg_slice1_bwd_bf16`` at 256px against two cuDNN bf16 convs (+ ReLUs) and
autograd over them; ``blur4_bf16`` at the forward shapes
(``main_path("blur4")``) and the adjoint's (``main_path("blur4_adj")``,
summed as ``blur4_bf16_adj``) against the depthwise bf16 ``F.conv2d``;
the 256px ToRGB skip chain (``--only upblur4``): its six levels as six
chained one-level launches (``upblur4_bf16_per_level``: rgb + upblur4 a
level; ``upblur4_adj_bf16_per_level``: the adjoint a level), as a tree before
the chain kernels ran it, and, where the tree has them, the chain in one
launch each way (``upblur4_bf16_chain``, ``upblur4_adj_bf16_chain``, held
bit-equal to the per-level launches), against the chained
``F.conv_transpose2d`` + add and the chained strided depthwise ``F.conv2d``.
CUDA events, median of 15 single launches after 3 warm-up launches (the
repo's launch-only time: the wrapper's host work is in it), the mean of
20 launches enqueued back to back (``back_to_back_ms``: device time where the
kernel outlasts the wrapper's host work), and the device time of a call
(``device_ms``: its kernels' self times under ``torch.profiler``).  Each result is also
held against the kernel's plain bf16 version (max|err| / max|plain| < 0.03,
the slice backward outside conv1's sign neighbourhoods).  Every result is a
JSON line with the card's name and power limit; the last line sums the
batch's shapes per kernel.

``--only step`` times the bf16 16-chain 256px perceptual solve step instead
(full width, random weights from a seed, 4 targets x 4 restarts, as
``chip_smoke.py``'s ``step16``): the median of 10 steps after 3 warm-up
steps (CUDA events), the device-busy time a step over 3 profiled steps
(``torch.profiler``), and the launches a step by kernel.
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


def device_ms(torch, fn, calls: int = 10) -> float:
    """Device time of ``fn`` a call: the self times of its CUDA kernels under
    ``torch.profiler``, summed."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.key_averages():
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = getattr(e, "self_cuda_time_total", 0.0)
        if dev > 0 and str(getattr(e, "device_type", "")).endswith("CUDA"):
            total += dev / 1e3 / calls
    return total


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=None, help="also append the JSON lines to this file")
    ap.add_argument("--only", choices=("conv", "slice", "blur4", "upblur4", "step"), default=None,
                    help="time one kernel's launches, or the bf16 solve step")
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
    if args.only == "step":
        return time_step(torch, import_module, _cuda, emit)

    def row(kernel, shape, kf, lf, bound, check):
        k, p, keep = check()
        torch.cuda.synchronize()
        diff = (k.float() - p.float()).abs()
        if keep is not None:
            diff = diff * keep
        err, pmax = diff.max().item(), p.float().abs().max().item()
        ok = bool(torch.isfinite(k).all()) and err < BF16_TOL * pmax
        line = {"kernel": kernel, "shape": shape, "batch": n, "ms": median_ms(torch, kf),
                "back_to_back_ms": back_to_back_ms(torch, kf), "device_ms": device_ms(torch, kf),
                "library_ms": median_ms(torch, lf),
                "bound_ms": bound["bound_ms"],
                "bound_by": bound["bound_by"], "max_abs_err": err, "max_abs_plain": pmax, "ok": ok}
        line["share_of_bound"] = line["bound_ms"] / line["ms"]
        emit(line)
        s = sums.setdefault(kernel, {"ms": 0.0, "back_to_back_ms": 0.0, "device_ms": 0.0, "library_ms": 0.0,
                                     "bound_ms": 0.0, "ok": True})
        for key in ("ms", "back_to_back_ms", "device_ms", "library_ms", "bound_ms"):
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
        if args.only in (None, "upblur4"):
            time_skip_chain(torch, F, up_cuda, upf, roof, n, rnd, row)
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


def time_skip_chain(torch, F, up_cuda, upf, roof, n, rnd, row):
    """The 256px skip chain's six levels both ways: as chained one-level launches,
    and (where the tree has the chain kernels) as one launch each way."""
    bf = torch.bfloat16
    k1 = upf.split_symmetric_4tap(upf.make_kernel((1, 3, 3, 1)) * 4.0)
    wl3 = torch.outer(*[torch.tensor(k1, device="cuda")] * 2).expand(3, 1, 4, 4).contiguous().to(bf)
    h0, levels = roof.UPBLUR4_SHAPES[0], len(roof.UPBLUR4_SHAPES)
    ts = [rnd(n, h0 << k, h0 << k, 3).to(bf) for k in range(levels + 1)]
    g = rnd(n, h0 << levels, h0 << levels, 3).to(bf)
    flat = lambda gs: torch.cat([t.flatten() for t in gs])  # noqa: E731

    def per_level():
        rgb = ts[0]
        for t in ts[1:]:
            rgb = up_cuda.upblur4_launch(rgb, k1, t)
        return rgb

    def per_level_adj():
        gs = [g]
        for _ in range(levels):
            gs.insert(0, up_cuda.upblur4_adjoint_launch(gs[0], k1))
        return gs[:-1]

    def library_fwd():
        rgb = ts[0].permute(0, 3, 1, 2)
        for t in ts[1:]:
            rgb = F.conv_transpose2d(rgb, wl3, stride=2, padding=1, groups=3) + t.permute(0, 3, 1, 2)
        return rgb

    def library_adj():
        gs = [g.permute(0, 3, 1, 2)]
        for _ in range(levels):
            gs.append(F.conv2d(gs[-1], wl3, stride=2, padding=1, groups=3))
        return gs

    def plain_fwd():
        rgb = ts[0]
        for t in ts[1:]:
            rgb = up_cuda.upblur4_add_plain(t, rgb, k1)
        return rgb

    def plain_adj():
        gs = [g]
        for _ in range(levels):
            gs.insert(0, up_cuda.upblur4_adjoint_plain(gs[0], k1))
        return flat(gs[:-1])

    label = f"C3_H{h0}-H{h0 << levels}"
    per_fwd = {"bound_ms": sum(c["bound_ms"] for _, c in roof.main_path("upblur4", n, "bfloat16")), "bound_by": "bytes"}
    per_adj = {"bound_ms": sum(c["bound_ms"] for _, c in roof.main_path("upblur4_adj", n, "bfloat16")),
               "bound_by": "bytes"}
    row("upblur4_bf16_per_level", label, per_level, library_fwd, per_fwd, lambda: (per_level(), plain_fwd(), None))
    row("upblur4_adj_bf16_per_level", label, per_level_adj, library_adj, per_adj,
        lambda: (flat(per_level_adj()), plain_adj(), None))
    if not hasattr(up_cuda, "upblur4_chain_launch"):
        return
    kf = lambda: up_cuda.upblur4_chain_launch(ts, k1)  # noqa: E731
    ka = lambda: up_cuda.upblur4_adj_chain_launch(g, k1, levels)  # noqa: E731

    def same(kfn, ref, plain):
        k, r = kfn(), ref()
        k, r = (k, r) if torch.is_tensor(k) else (flat(k), flat(r))
        if not torch.equal(k, r):
            raise RuntimeError("the chain launch is not bit-equal to the per-level launches")
        return k, plain(), None

    row("upblur4_bf16_chain", label, kf, library_fwd, roof.upblur4_chain(n, 3, h0, levels, "bfloat16"),
        lambda: same(kf, per_level, plain_fwd))
    row("upblur4_adj_bf16_chain", label, ka, library_adj, roof.upblur4_adj_chain(n, 3, h0, levels, "bfloat16"),
        lambda: same(ka, per_level_adj, plain_adj))


def time_step(torch, import_module, _cuda, emit) -> int:
    """The bf16 16-chain 256px perceptual solve step: median of 10 steps (CUDA
    events) after 3 warm-up steps, device busy over 3 profiled steps, launches a
    step."""
    from torch.profiler import ProfilerActivity, profile

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    C = import_module(f"{P}.config")
    pl = import_module(f"{P}.fingerprint.pipeline")
    attr = import_module(f"{P}.fingerprint.attribute")
    lhs = import_module(f"{P}.utils.lhs")
    mcfg = C.ModelConfig(img_size=256)
    pipe = pl.build_pipeline(mcfg, C.FingerprintConfig(key_len=64, shift=448),
                             generator=torch.Generator().manual_seed(0), device="cuda")
    targets = torch.clamp(pl.generate_fingerprinted(pipe, 4, torch.Generator().manual_seed(1))[0], -1.0, 1.0)
    acfg = C.AttributionConfig(steps=20, n_starts=4, loss="perceptual")
    feats, _ = attr._targets_for_loss(pipe.lpips_params, targets, acfg, "bfloat16")
    step = attr.make_attribution_step(pipe.gen_params, pipe.lpips_params, pipe.basis, pipe.noise, mcfg, acfg, feats,
                                      None, dtype="bfloat16")[0]
    alpha0 = torch.as_tensor(lhs.lhs_alpha_init_batch(4, 4, pipe.basis.sigma_rest, torch.Generator().manual_seed(2)),
                             dtype=torch.float32).cuda()
    holder = [attr.init_state(alpha0, torch.zeros((4, 4, 64), device="cuda"))]

    def one():
        holder[0], per = step(holder[0])
        return per

    one()
    torch.cuda.synchronize()
    _cuda.reset_launches()
    one()
    torch.cuda.synchronize()
    launches = {k: v for k, v in _cuda.launch_counts().items() if v}
    ms = median_ms(torch, one, reps=10, warmup=3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            one()
        torch.cuda.synchronize()
    busy = 0.0
    for e in prof.key_averages():
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = getattr(e, "self_cuda_time_total", 0.0)
        if dev > 0 and str(getattr(e, "device_type", "")).endswith("CUDA"):
            busy += dev / 1e3 / 3
    emit({"kernel": "step16_bf16", "ms_median": ms, "device_busy_ms": busy, "device_busy_share": busy / ms,
          "launches_per_step": launches})
    return 0


if __name__ == "__main__":
    sys.exit(main())
