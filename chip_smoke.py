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
               (``library_ms``), the card's bound for the work
               (``ops/roofline.py``) and the kernel's share of that bound
               (``share_of_bound``).  blur4 is launched at its forward shapes
               and at its adjoint shapes (``_adj``: pads (2, 2), unflipped
               taps, H -> H + 1: the backward's six launches a step).  blur4
               (both), conv3x3_relu (forward and dx), the vgg_slice1 forward
               and its backward are held against plain again at both batches.
               blur4 also at the discriminator's shapes (``D_``: C 128..512 at
               256..8 px, pads (2, 2) and (1, 1), odd outputs): forward and dx
               at batch 2, launch-only forward and adjoint at batch 16 (summed
               under ``disc_`` keys).  Then the second derivative through the
               FIR kernels (R1's gradient of a gradient) against the plain
               versions on the CPU.  The launch rows run once more at the
               1024px main path's shapes (StyleGAN2 config-f, LPIPS on the
               1024^2 image: ``blur4`` up to C 32 x 1024^2, ``conv3x3_relu``
               up to C 128 x 512^2, the slice at 1024^2, the skip chain over 8
               levels) at batch 2, held the same way, each launch twice and the
               two results bitwise equal.
3. recovery -- planted keys recovered through the kernels on a tiny
               generator (32px, mse loss, 300 steps, 4 restarts, 3 samples).
4. generate -- ``cli.generate`` at full width (256px, style_dim 512, n_mlp 8,
               channel_max 512) writes its PNGs.
5. attribute-- ``cli.attribute`` at full width with the perceptual loss
               (2 samples x 4 restarts, 20 steps); every kernel's launch
               count over this run must be > 0.  A second run of 10 steps
               gives the launches per solve step as the difference of the
               two runs' counts over the difference in steps; it runs with
               ``--profile``: its phase report has the reference's header and
               one row each of build_pipeline, generate_targets and
               solve_chunk, and its Chrome trace names ``conv3x3_tc_kernel``
               and ``blur4_kernel`` (then the trace is deleted).
6. attacks  -- every attack and every solver attack at (2, 256, 256, 3) on the
               card against the same function on the CPU copy of the input
               (1e-5; Jpeg with differentiable rounding 2e-4; hard-rounded
               Jpeg: at least 99.9% of pixels within 2e-4, since a coefficient
               within rounding of a half-integer moves its block by a whole
               quantisation step); the solver attacks' gradients are finite.
7. robust   -- the tiny configuration of phase 3 under the Blur attack, solved
               attack-aware from one set of starts: alone, with the restarts
               in chunks of two (which must give the unchunked run's key bits
               and best start), and with successive halving (half the schedule
               as warm phase: this sample's winning restart blooms late) and a
               polish sweep on.  Each run is held to phase 3's criterion.
8. attacked -- ``cli.attribute`` at full width on Jpeg-attacked targets,
               attack-aware, pruned to 2 restarts, one polish sweep, in sample
               chunks of one (20 steps); every kernel's launch count over this
               run must be > 0.  Then the same run twice more with cuDNN held
               to its deterministic algorithms (with the default ones two runs
               of one seed differ, and at 20 steps on random weights a rounding
               difference decides bits): once whole, and once as a copy of that
               run directory set back to the end of its first chunk and
               finished with ``--resume``: the two ``result.txt`` must be equal.
9. encoder  -- the encoder (``fingerprint/encoder.py``) trained 200 steps at
               full width, 256px, batch 16, on the Jpeg channel: finite loss
               whose last 20 steps average below the first 10, ``blur4`` and
               ``upblur4`` launched, steps/s, images/s, peak memory at batch 16
               and (3 steps) at batch 64, and the device time of the render vs
               the encoder's step (``torch.profiler``).  Then the tiny
               configuration at the reference's budget (400 steps, batch 16):
               zero-step decode above 0.55 over 256 samples, and the encoder-init
               solve (150 steps, 4 restarts) no worse than the LHS solve from
               the same generator by more than one bit (1/8) on 3 samples,
               with cuDNN held to its deterministic algorithms (with the
               default ones the encoder differs run to run, and so do the
               bits its solve starts from: ``tools/encoder_tiny_spread.py``).
10. attribute_encoder -- ``cli.attribute --init encoder --profile`` at full
               width (2 x 4 chains, 20 steps, 100 encoder steps, Jpeg,
               attack-aware): it prints its encoder line, writes
               ``result.txt``, launches every kernel; its phase report has the
               reference's four phases (train_encoder too) and its trace the
               kernels of phase 5's.
11. serve   -- ``cli.serve``'s engine at full width (buckets 1 and 4,
               perceptual, 20 steps, 4 restarts, encoder init of 100 steps, a
               16-user registry) behind the HTTP server on port 0: 8 concurrent
               /v1/generate from a client process (half of them as users:
               their keys come back verbatim) coalesce into fewer batches, then
               two bursts of 16 concurrent PNG requests (images/s at bucket 4,
               the server cold and warm), /v1/attribute,
               /v1/identify (all six kernels launched) and /v1/stats, with
               client-side latency per route; the layers under it alone (the
               engine solo and as a burst of 16 without HTTP, the server's PNG
               and float-list encodings of one image); then the engine's batch
               function alone per (kind, bucket), where one seed gives the same
               image at bucket 1 and 4 (1e-3).  Then the tiny
               configuration served (300 steps): identify names the planted
               users.
12. biggan  -- BigGAN-deep-256 at full width (random weights from a seed, key
               on the last 32 of its 128 axes, perceptual): ``cli.generate
               --model biggan`` writes its PNGs; ``cli.attribute --model
               biggan`` (2 samples x 4 restarts, 20 steps) launches the LPIPS
               kernels (``conv3x3_relu``, both ``vgg_slice1``) and none of the
               StyleGAN2 FIR kernels; the 16-chain solve step alone (CUDA
               events, median of 5), its peak memory and its device time by
               kernel (``torch.profiler``), generation images/s at
               batch 16, the forward's multiply-adds counted from the config.
               Then a tiny BigGAN (32px, attention) recovers planted keys (200
               steps, 4 restarts, 3 samples) as phase 3's generator does.
13. model_attribution -- ``cli.model_attribute --random_init`` at full width:
               two StyleGAN2s at 256px, self-test of 2 targets, ``--calibrate 1``,
               4 restarts x 20 steps, perceptual, ``--out`` JSON; its loss matrix,
               decisions, wall time and launch counts (all six kernels).  Then
               ``attribute_model`` over a mixed registry {StyleGAN2-256,
               BigGAN-deep-256} with one key length, one planted target of each:
               its loss matrix.  Then the tiny configuration: a registry of two
               generators and a held-out one; every registry target is named for
               its model and every held-out target is rejected at the threshold
               ``cli.model_attribute.calibrate`` sets from in-distribution solves
               (450 mse steps, 4 restarts, as the reference package's test).
14. train   -- StyleGAN2-256 training at full width (``training/gan.py``,
               random weights from a seed, batch 16, lazy R1 every 4 steps): the
               launches of a step with R1 and of one without against
               ``ops/roofline.py::train_launches``, 8 timed steps (CUDA events),
               peak memory, finite losses on the R1 schedule, and the device
               time by kernel over 4 steps (``torch.profiler``).
15. train_tiny -- ``cli.train`` at its defaults (64px, channel_max 128, batch
               16), one process a run under ``cudnn.deterministic``: 40 steps
               with a snapshot resumed to 80 equal (both exports) to 80 steps
               uninterrupted, one metrics row a step; then ``cli.attribute
               --ckpt`` on the trained generator, its bit accuracy printed.
16. studies -- the quality studies (``cli.study``) on the card at the study's
               width (64 px, channel_max 128, style_dim 512, n_mlp 8, trained
               at batch 16, 600 steps deep where the recipe says 3000, PCA
               over 10000 samples), one process a run: a robustness point with the first training, the five
               perceptual backbones on Jpeg (the two calibrated ones fit their
               2AFC heads), an identification point, ``capacity`` on the
               cached recipe (nothing trained: its FID sweep over 8 samples,
               500 steps x 8 restarts in bf16, FID from random Inception and
               the discriminator's Frechet distance, then the full-budget
               sweep; 4 records with finite visibility and a full-budget
               accuracy, the bf16 FIR kernels in the solves, float32
               ``conv3x3_relu`` / ``vgg_slice1_fwd`` in the visibility LPIPS;
               its process seconds, the host seconds of its Frechet distances,
               Inception images/s, peak memory), the perceptual run again (all
               cached, no launch), then ``cli.report`` of the four;
               ``--samples 2 --steps 40 --n 4`` (the study's 20 / 2000 / 20).
17. evaluate -- ``cli.evaluate --random_init --with_fid`` at full width
               (256px, style_dim 512, n_mlp 8, channel_max 512; key_len 64,
               sigma 1, 2 samples, 20 steps x 4 restarts, perceptual,
               float32): every float32 kernel launched, finite FID and
               visibility, ``mean_latent_cos``; the host seconds of its
               Frechet distance.  Then Inception alone at 299 px (batch 16:
               CUDA-event median, images/s; batch 2 and ``preprocess`` at
               256 -> 299 and 512 -> 299 against the CPU, 1e-4), the AlexNet
               and SqueezeNet backbones, ``lpips_net_mode``, ``dssim_per_sample``
               and ``mse_per_sample`` at (2, 256, 256, 3) against the CPU
               (within 1e-4 of the CPU side's largest magnitude), the
               train-mode attacks at every fixed draw against the CPU (1e-5),
               and ``cli.attribute --lpips_net squeeze`` (2 x 4 chains, 10
               steps): the FIR kernels launched and no LPIPS kernel.
18. parallel -- one ``python -m torch.distributed.run --standalone
               --nproc_per_node 2`` launch of this script's worker mode
               (``--parallel-worker``): two ranks on the one card over gloo
               (nccl refuses two ranks on one device), cuDNN deterministic.
               Each rank runs ``cli.attribute --mesh_data 2`` at full width
               (256px, perceptual, 2 samples x 4 restarts, float32) for 10
               steps (every float32 kernel launched by each rank; one run
               directory, rank 0's) and for 1 step, the tiny configuration's
               planted keys on 4 samples through ``attribute_on_mesh`` (phase
               3's criterion: mean bit accuracy above 0.85, at least 3 of 4
               exact), ``cli.train --mesh_data 2`` (64px, batch 16, 8 steps),
               full-width generation on a 1 x 2 mesh (the model axis: each rank
               half of every styled conv's channels) against the unsharded
               images (``TOL`` of max) with ``blur4`` launched at the halved
               shapes, and ``cli.serve``'s engine on the data mesh at bucket 2
               (rank 0 serves one /v1/generate and one /v1/attribute over HTTP,
               rank 1 follows its batches).  This process runs the same
               ``cli.attribute`` and ``cli.train`` on one device: equal bit
               accuracies, the 1-step losses within ``PARALLEL_LOSS_RTOL`` (the
               10-step ones are printed: free solves part through Adam),
               training metrics within the reference's mesh-test tolerance;
               and ``blur4`` at the halved shapes against its plain version,
               timed beside its bound.  It prints the backend, each rank's
               device and the phase's seconds.

bfloat16 (``--dtype bfloat16``, the ``*_bf16`` variants of the six kernels):
2.  the launch-only rows of phase 2 again in bf16 at batch 2 and 16 (``_bf16``
    names): each kernel within 0.03 * max|plain| of its plain bf16 version,
    and (but the slice's backward, whose ReLU masks differ) within 0.03 of
    max of the float32 plain version on the same (bf16) inputs, the
    launch-only, plain and library times (the PyTorch calls in bf16; for the
    slice two cuDNN convs + ReLU, autograd over them for its backward) and the
    bf16 bound; ``upblur4_bf16`` / ``upblur4_adj_bf16`` at the six per-level
    shapes are one-level launches, and the whole 256px skip chain follows as one
    launch each way (``chain_`` rows: bit-equal to the six chained one-level
    launches, within 0.03 of the plain chain, launch-only, back-to-back and
    device times, the library call chaining ``F.conv_transpose2d`` + add or the
    strided depthwise ``F.conv2d``); the FIR second derivative once in bf16
    against the plain bf16 versions on the CPU (0.03 of max), the skip chain's
    among them.  ``blur4_bf16`` at the discriminator's shapes (``D_`` rows, the
    disc perceptual backbone's: forward and adjoint against plain bf16 at batch
    2, with the study's 64 px discriminator too; launch-only, plain and library
    times at batch 16 under ``disc_`` keys).
3.  recovery in bf16: phase 3's tiny configuration and gates, ``dtype="bfloat16"``.
5.  attribute_1024 -- the main path at 1024 px, full width (StyleGAN2
    config-f from ``--random_init``, LPIPS-VGG16 on the 1024^2 image, key_len
    64, shift 448): ``cli.generate`` writes 1024^2 PNGs; the perceptual solve
    step alone at 4 and 8 chains in float32, float32 ``remat``, float32
    ``remat`` + ``remat_lpips``, bf16 and bf16 ``remat``: peak memory, the
    largest chain count the card holds (a line through the two peaks), the
    median step by CUDA events, launches per step held to
    ``ops/roofline.py::step_launches(dtype, 1024, remat, remat_lpips)``, the
    step-1 losses of each checkpointed variant within 1e-6 relative of its
    dtype's plain step and its peak below it; then ``cli.attribute`` (2 x 4
    chains, 10 steps) in float32, float32 ``--remat`` and bf16 ``--remat``:
    every kernel of its dtype launched, its launches outside the float32
    renders and the targets' features ten solve steps', losses printed.
5.  step16 -- the 16-chain 256px perceptual solve step at full width in the
    turns float32, bf16, bf16, float32 (CUDA events, median of 5 steps a
    turn), each dtype's peak memory, device-busy share and top device
    operations (``torch.profiler``), and its launches per step, which must be
    ``ops/roofline.py::step_launches`` of that dtype and 0 for the other
    dtype's kernels (in bf16 the skip chain once each way).  attribute_bf16 --
    ``cli.attribute --dtype bfloat16`` as phase 5 runs it: finite losses,
    ``result.txt``, every bf16 kernel launched, float32 kernels only inside
    ``pipeline.synthesize`` (the float32 renders of the targets and the stored
    images); chain-steps/s and peak memory beside phase 5's; a second run of 10
    steps gives its launches per step, held to ``step_launches("bfloat16")``.
9.  the encoder's bf16 renders: one ``upblur4_bf16`` launch each, none of the
    adjoint.
12. the BigGAN-deep-256 16-chain step in bf16 (the reference widens the bf16 z
    where it meets the class embedding, so its generator and the LPIPS on its
    image stay float32; only the targets' features are bf16).
13. studies_bf16 -- ``identification_point`` and ``model_attribution_point`` at
    their defaults (bf16) on the tiny configuration, short, with launch
    counts: float32 kernels only in the target renders, as in attribute_bf16.
16. the studies solve in bf16: every ``_bf16`` kernel launched by the
    perceptual run (``blur4_bf16`` inside the discriminator's feature pass),
    float32 kernels only in the target renders, the calibration and the
    training.

Then it prints the card's name and power limit, one JSON line describing
each kernel (its launches on every path above: ``launches`` is phase 5's for
a float32 kernel and the bf16 ``cli.attribute`` run's for a ``_bf16`` one,
``launches_1024_*`` the 1024px ``cli.attribute`` runs' and
``launches_per_step_1024`` the 1024px solve steps', ``px1024_*`` the times,
bounds and errors of the 1024px shapes at batch 2,
``launches_training`` phase 14's timed steps, ``launches_studies`` phase 16's
three study runs, ``launches_capacity`` its capacity run, ``launches_evaluate``
phase 17's ``cli.evaluate``, ``launches_parallel`` each rank's in phase 18's
``cli.attribute --mesh_data 2``; the bf16 skip chain's times are
its one launch, its per-level shapes under ``per_level_``), and, last,
``{"ok": true, "device": {...}}``.  Without a CUDA
device, or without the port's package beside it, it exits non-zero at once.
"""

from __future__ import annotations

import contextlib
import io
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
BF16_TOL = 0.03  # bf16 kernel vs its plain bf16 version: max|err| / max|plain| (the reference's bf16 kernel bound)
BF16 = None  # name suffix of a kernel's bfloat16 variant: ops/roofline.py's BF16_SUFFIX, read in main()
# the tiny converging configuration of the reference's end-to-end test
TINY = dict(img_size=32, style_dim=64, n_mlp=3, channel_max=64)
TINY_SEED = 1
# the whole run, the kernels' build included, must end within 1200 s: every child process gets at
# most what is left of BUDGET_S, and the watchdog ends the run (children included) at WATCHDOG_S
BUDGET_S, WATCHDOG_S = 1100, 1150
T0 = time.time()
CHILDREN = set()  # the process groups of the children running now


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def time_left(cap: float) -> float:
    """The seconds a child process may take: ``cap``, cut to what is left of BUDGET_S."""
    left = BUDGET_S - (time.time() - T0)
    check(left > 0, f"the run has used its {BUDGET_S} s")
    return min(cap, left)


def run_child(cmd, cap: float, input=None, **kw) -> subprocess.CompletedProcess:
    """``subprocess.run(cmd, capture_output=True, text=True)`` in a process group of
    its own, within ``time_left(cap)``: past it the whole group (torch.distributed.run's
    ranks too) is killed and the check fails with the child's last output."""
    import signal

    p = subprocess.Popen(cmd, stdin=subprocess.PIPE if input is not None else None, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True, start_new_session=True, **kw)
    CHILDREN.add(p.pid)
    try:
        out, err = p.communicate(input, timeout=time_left(cap))
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        out, err = p.communicate()
        print(out[-6000:], end="", flush=True)
        check(False, f"{cmd[:4]} still running after {cap} s (or the run's budget): {err[-3000:]}")
    finally:
        CHILDREN.discard(p.pid)
    return subprocess.CompletedProcess(cmd, p.returncode, out, err)


def start_watchdog() -> None:
    """End the run with a message and exit code 1 if it is still going at WATCHDOG_S,
    killing the children's process groups first (a hang fails loudly, inside the limit)."""
    import signal
    import threading

    def watch():
        time.sleep(max(0.0, WATCHDOG_S - (time.time() - T0)))
        print(f"chip_smoke: still running after {WATCHDOG_S} s; stopped", file=sys.stderr, flush=True)
        for pid in list(CHILDREN):
            with contextlib.suppress(OSError):
                os.killpg(pid, signal.SIGKILL)
        os._exit(1)

    threading.Thread(target=watch, daemon=True).start()


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
    order than cuDNN's, so there the two [conv1 > 0] masks may differ.  conv1 is
    summed in float32 from the values the kernel sees (a bf16 x with w1 rounded
    to bf16)."""
    import torch.nn.functional as F

    z1 = vgg_cuda.conv3x3_plain(x.float(), w1.to(x.dtype).float(), b1)
    near = (z1.abs().amin(dim=-1, keepdim=True) < 1e-5).float().permute(0, 3, 1, 2)
    near = F.max_pool2d(near, 3, stride=1, padding=1).permute(0, 2, 3, 1) > 0
    return ~near.expand(-1, -1, -1, 3)


def phase_kernels(torch, mods, disc_shapes):
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
    k0 = upf.split_symmetric_4tap(upf.make_kernel((1, 3, 3, 1)))  # the discriminator's blur: no gain
    for c, r in disc_shapes:
        for p in (2, 1):  # before the 3x3 stride-2 conv (out r + 1), before the 1x1 skip (out r - 1)
            o = r + 2 * p - 3
            cases.append(("blur4", f"D_C{c}_R{r}_p{p}{p}",
                          lambda v, p=p: up_cuda.blur4(v, k0, k0, (p, p), (p, p)),
                          lambda v, p=p: up_cuda.blur4_plain(v, k0, k0, (p, p), (p, p)),
                          rnd(2, r, r, c), rnd(2, o, o, c)))
    for h in (4, 8, 16, 32, 64, 128):
        # the ToRGB skip as the main path runs it: rgb + upblur4(skip) in one launch,
        # dx through the adjoint kernel
        rgb = rnd(2, 2 * h, 2 * h, 3)
        cases.append(("upblur4", f"C3_H{h}", lambda v, rgb=rgb: up_cuda.upblur4_add(rgb, v, k1),
                      lambda v, rgb=rgb: rgb + up_cuda.upblur4_plain(v, k1), rnd(2, h, h, 3),
                      rnd(2, 2 * h, 2 * h, 3)))
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
        if shape.startswith("D_"):  # errors held like the rest; times apart from the main path's sums
            agg["err_fwd"], agg["err_dx"] = max(agg["err_fwd"], errs["fwd"]), max(agg["err_dx"], errs["dx"])
            continue
        agg["err_fwd"] = max(agg["err_fwd"], errs["fwd"])
        agg["err_dx"] = max(agg["err_dx"], errs["dx"])
        for key in ("ms_fwd", "plain_ms_fwd", "ms_bwd", "plain_ms_bwd"):
            agg[key] += t[key]
    return per_kernel


def launch_cases(torch, mods, n, rnd, act=None, img_size=256):
    """Every launch shape of every kernel on the main path at ``img_size`` at batch ``n``:
    (kernel, shape, kernel_fn, plain_fn, library_fn, counts, check), all on
    fixed inputs and without autograd.  ``library_fn`` is the PyTorch call
    that computes the same function; the port never calls it on the card.
    ``check`` is None or a function returning (kernel result, plain result,
    mask of elements to compare or None).  ``act`` maps every activation input
    (not the float32 parameters) after it is drawn: ``t.bfloat16()`` gives the
    bf16 variants' cases (the library call in bf16 too), and the bound is
    then counted in bf16.  The discriminator's rows come with the 256px path only."""
    import torch.nn.functional as F

    up_cuda, vgg_cuda, slice_cuda, upf, roof = mods
    k1 = upf.split_symmetric_4tap(upf.make_kernel((1, 3, 3, 1)) * 4.0)
    kt = torch.tensor(k1, device="cuda")
    bf16_route = act is not None  # the bf16 cases and their float32 references: the chain rows too
    # the discriminator's rows: float32 at batch 16 (batch 2 is held through autograd in phase 2's
    # first part); bf16 at both, at batch 2 the study's discriminator (64 px, channel_max 128) too
    disc = (n == 16 or bf16_route) and img_size == 256
    if act is None:
        act = lambda t: t  # noqa: E731
    dt = act(torch.zeros(1, device="cuda")).dtype  # the kernels' dtype
    dname = "bfloat16" if dt == torch.bfloat16 else "float32"
    cases = []

    def arnd(*shape):
        return act(rnd(*shape))

    def adjoint(ct, w):
        """conv3x3_plain's adjoint applied to ``ct``, by autograd (the conv is linear)."""
        with torch.enable_grad():
            x0 = torch.zeros_like(ct).requires_grad_(True)
            return torch.autograd.grad(vgg_cuda.conv3x3_plain(x0, w), x0, ct)[0]

    for c, h in roof.blur4_shapes(img_size):
        x = arnd(n, h + 1, h + 1, c)
        wl = torch.outer(kt, kt).flip(0, 1).expand(c, 1, 4, 4).contiguous().to(dt)
        kf = lambda x=x: up_cuda.blur4_launch(x, k1[::-1], k1[::-1], (1, 1), (1, 1))
        pf = lambda x=x: up_cuda.blur4_plain(x, k1, k1, (1, 1), (1, 1))
        cases.append(("blur4", f"C{c}_H{h}", kf, pf,
                      lambda x=x, wl=wl, c=c: F.conv2d(x.permute(0, 3, 1, 2), wl, padding=1, groups=c),
                      roof.blur4(n, c, h, h, dtype=dname), lambda kf=kf, pf=pf: (kf(), pf(), None)))
    for c, h in roof.blur4_shapes(img_size):
        # the backward's launch: the cotangent [n, h, h, c] through the same kernel with
        # unflipped taps and pads (3 - 1, 3 - 1); blur4_plain flips the taps it is given
        x = arnd(n, h, h, c)
        wl = torch.outer(kt, kt).expand(c, 1, 4, 4).contiguous().to(dt)
        kf = lambda x=x: up_cuda.blur4_launch(x, k1, k1, (2, 2), (2, 2))
        pf = lambda x=x: up_cuda.blur4_plain(x, k1[::-1], k1[::-1], (2, 2), (2, 2))
        cases.append(("blur4", f"C{c}_H{h}_adj", kf, pf,
                      lambda x=x, wl=wl, c=c: F.conv2d(x.permute(0, 3, 1, 2), wl, padding=2, groups=c),
                      roof.blur4(n, c, h + 1, h + 1, (2, 2), dname), lambda kf=kf, pf=pf: (kf(), pf(), None)))
    if disc:
        # the discriminator's blurs at full width (batch 16) and their adjoints: pads p on
        # [n, r, r, c] and, for the adjoint, pads 3 - p on the forward's output
        k0 = upf.split_symmetric_4tap(upf.make_kernel((1, 3, 3, 1)))
        k0t = torch.tensor(k0, device="cuda")
        counts = dict(roof.main_path("blur4_disc", n, dname))
        shapes = list(roof.DISC_BLUR_SHAPES)
        if bf16_route and n == 2:
            counts.update(roof.main_path("blur4_disc_study", n, dname))
            shapes += list(roof.STUDY_DISC_BLUR_SHAPES)
        for c, r in shapes:
            for p, adj in ((2, False), (1, False), (2, True), (1, True)):
                q, size = (3 - p, r + 2 * p - 3) if adj else (p, r)
                label = f"D_C{c}_R{r}_p{p}{p}" + ("_adj" if adj else "")
                x = arnd(n, size, size, c)
                taps = k0 if adj else k0[::-1]  # the launch takes correlation taps; the adjoint's are unflipped
                wl = (torch.outer(k0t, k0t) if adj else torch.outer(k0t, k0t).flip(0, 1)).expand(c, 1, 4, 4)
                wl = wl.contiguous().to(dt)
                kf = lambda x=x, t=taps, q=q: up_cuda.blur4_launch(x, t, t, (q, q), (q, q))
                pf = lambda x=x, t=taps, q=q: up_cuda.blur4_plain(x, t[::-1], t[::-1], (q, q), (q, q))
                cases.append(("blur4", label, kf, pf,
                              lambda x=x, wl=wl, c=c, q=q: F.conv2d(x.permute(0, 3, 1, 2), wl, padding=q, groups=c),
                              counts[label], lambda kf=kf, pf=pf: (kf(), pf(), None)))
    wl3 = torch.outer(kt, kt).expand(3, 1, 4, 4).contiguous().to(dt)
    for h in roof.upblur4_shapes(img_size):
        x, rgb = arnd(n, h, h, 3), arnd(n, 2 * h, 2 * h, 3)
        kf = lambda x=x, rgb=rgb: up_cuda.upblur4_launch(x, k1, rgb)
        pf = lambda x=x, rgb=rgb: up_cuda.upblur4_add_plain(rgb, x, k1)
        cases.append(("upblur4", f"C3_H{h}", kf, pf,
                      lambda x=x, rgb=rgb: F.conv_transpose2d(x.permute(0, 3, 1, 2), wl3, stride=2, padding=1,
                                                              groups=3) + rgb.permute(0, 3, 1, 2),
                      roof.upblur4(n, 3, h, h, fused=True, dtype=dname), lambda kf=kf, pf=pf: (kf(), pf(), None)))
    for h in roof.upblur4_shapes(img_size):
        g = arnd(n, 2 * h, 2 * h, 3)

        def plain_adjoint(g=g, h=h):
            """upblur4_plain's adjoint applied to g, by autograd (the FIR is linear)."""
            with torch.enable_grad():
                x0 = torch.zeros((n, h, h, 3), device="cuda", dtype=dt).requires_grad_(True)
                return torch.autograd.grad(up_cuda.upblur4_plain(x0, k1), x0, g)[0]

        kf = lambda g=g: up_cuda.upblur4_adjoint_launch(g, k1)
        cases.append(("upblur4_adj", f"C3_H{h}", kf, lambda g=g: up_cuda.upblur4_adjoint_plain(g, k1),
                      lambda g=g: F.conv2d(g.permute(0, 3, 1, 2), wl3, stride=2, padding=1, groups=3),
                      roof.upblur4_adj(n, 3, h, h, dname), lambda kf=kf, pa=plain_adjoint: (kf(), pa(), None)))
    if bf16_route:
        cases += chain_cases(torch, up_cuda, roof, n, arnd, k1, wl3, dt, dname, img_size)
    for c, h, _ in roof.conv3x3_shapes(img_size):
        w, b = rnd(3, 3, c, c, scale=(2.0 / (9 * c)) ** 0.5), rnd(c, scale=0.1)
        x = arnd(n, h, h, c)
        # the adjoint taps (spatial flip, in/out swapped) for the TIMES of the plain and the
        # library call; the dx check below takes the adjoint from autograd instead
        wf = w.flip(0, 1).transpose(2, 3).contiguous()
        w_oihw, wf_oihw = (t.permute(3, 2, 0, 1).contiguous().to(dt) for t in (w, wf))
        kf = lambda x=x, w=w, b=b: vgg_cuda.conv3x3_launch(x, w, b, relu=True)
        pf = lambda x=x, w=w, b=b: vgg_cuda.conv3x3_relu_plain(x, w, b)
        cases.append(("conv3x3_relu", f"C{c}_H{h}", kf, pf,
                      lambda x=x, wo=w_oihw, b=b.to(dt): torch.relu(F.conv2d(x.permute(0, 3, 1, 2), wo, b, padding=1)),
                      roof.conv3x3(n, h, h, c, dname), lambda kf=kf, pf=pf: (kf(), pf(), None)))
        kd = lambda x=x, w=w: vgg_cuda.conv3x3_launch(x, w, None, relu=False, flip=True)
        pd = lambda x=x, wf=wf: vgg_cuda.conv3x3_plain(x, wf)
        cases.append(("conv3x3_relu", f"C{c}_H{h}_dx", kd, pd,
                      lambda x=x, wo=wf_oihw: F.conv2d(x.permute(0, 3, 1, 2), wo, None, padding=1),
                      roof.conv3x3(n, h, h, c, dname), lambda kd=kd, x=x, w=w: (kd(), adjoint(x, w), None)))
    ws = (rnd(3, 3, 3, 64, scale=(2.0 / 27) ** 0.5), rnd(64, scale=0.1),
          rnd(3, 3, 64, 64, scale=(2.0 / 576) ** 0.5), rnd(64, scale=0.1))
    hs = img_size  # VGG slice 1 runs on the image
    x, cot = arnd(n, hs, hs, 3), arnd(n, hs, hs, 64)
    kf, pf = (lambda: slice_cuda.slice1_forward_launch(x, *ws)), (lambda: slice_cuda.vgg_slice1_plain(x, *ws))
    # the library call: two cuDNN convs with their ReLUs in the kernels' dtype (NCHW views of
    # the NHWC tensors), and autograd over them for the backward
    wl = [t.permute(3, 2, 0, 1).contiguous().to(dt) if t.dim() == 4 else t.to(dt) for t in ws]

    def library_slice(v):
        return torch.relu(F.conv2d(torch.relu(F.conv2d(v.permute(0, 3, 1, 2), wl[0], wl[1], padding=1)),
                                   wl[2], wl[3], padding=1))

    # every element is compared: a ReLU output needs no mask
    cases.append(("vgg_slice1_fwd", f"C3_H{hs}", kf, pf, lambda: library_slice(x), roof.slice1_fwd(n, hs, hs, dname),
                  lambda: (kf(), pf(), None)))
    xr, xl = x.detach().requires_grad_(True), x.detach().requires_grad_(True)
    with torch.enable_grad():
        yp, yl = slice_cuda.vgg_slice1_plain(xr, *ws), library_slice(xl)
    a2 = yp.detach()

    def plain_bwd():
        return torch.autograd.grad(yp, xr, cot, retain_graph=True)[0]

    def library_bwd():
        return torch.autograd.grad(yl, xl, cot.permute(0, 3, 1, 2), retain_graph=True)[0]

    def kernel_bwd():
        return slice_cuda.slice1_backward_launch(cot, a2, x, ws[0], ws[1], ws[2])

    def check_bwd():
        # Both sides take the plain forward's a2.  conv1's sign is recomputed by the
        # kernel in another summation order than cuDNN's, so where |conv1(x) + b1| is
        # within float32 rounding of zero the two masks may differ: those pixels'
        # 3x3 neighbourhoods in dx are left out, and counted.
        return kernel_bwd(), plain_bwd(), conv1_sign_keep(torch, vgg_cuda, x, ws[0], ws[1])

    cases.append(("vgg_slice1_bwd", f"C3_H{hs}", kernel_bwd, plain_bwd, library_bwd,
                  roof.slice1_bwd(n, hs, hs, dname), check_bwd))
    return cases


def chain_cases(torch, up_cuda, roof, n, arnd, k1, wl3, dt, dname, img_size=256):
    """The bf16 ToRGB skip chain of the main path at ``img_size`` as a synthesis
    runs it, one launch each way (``chain_`` rows; at 256 px: ``upblur4_bf16`` over
    t_0 .. t_6 and ``upblur4_adj_bf16`` from the image's cotangent to g_0 .. g_5,
    flattened and concatenated; at 1024 px the cascade's two widest levels go as
    one-level launches first), each held bit-equal to the chained one-level launches and
    against the plain chain; the library call chains ``F.conv_transpose2d`` + add,
    or the depthwise strided ``F.conv2d``.  In float32 (the references of the bf16
    rows) the kernel side is the six float32 launches a level."""
    import torch.nn.functional as F

    (label, fwd_counts), = roof.main_path("upblur4_chain", n, dname, img_size)
    (_, adj_counts), = roof.main_path("upblur4_adj_chain", n, dname, img_size)
    h0, levels = 4, roof.chain_levels(img_size)
    ts = [arnd(n, h0 << k, h0 << k, 3) for k in range(levels + 1)]
    g = arnd(n, h0 << levels, h0 << levels, 3)
    bf16 = dt == torch.bfloat16

    def chained():
        rgb = ts[0]
        for t in ts[1:]:
            rgb = up_cuda.upblur4_launch(rgb, k1, t)
        return rgb

    def chained_adj():
        gs = [g]
        for _ in range(levels):
            gs.insert(0, up_cuda.upblur4_adjoint_launch(gs[0], k1))
        return gs[:-1]

    flat = lambda gs: torch.cat([t.flatten() for t in gs])  # noqa: E731
    kf = (lambda: up_cuda.upblur4_chain_launch(ts, k1)) if bf16 else chained
    ka = (lambda: up_cuda.upblur4_adj_chain_launch(g, k1, levels)) if bf16 else chained_adj
    pf = lambda: up_cuda.upblur4_chain_plain(ts, k1)  # noqa: E731
    pa = lambda: flat(up_cuda.upblur4_adj_chain_plain(g, k1, levels)[:-1])  # noqa: E731

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

    def check_chain(kfn, chained_fn, plain_fn, what):
        k, c = kfn(), chained_fn()
        k, c = (k, c) if torch.is_tensor(k) else (flat(k), flat(c))
        check(not bf16 or torch.equal(k, c), f"{what} batch {n}: not bit-equal to the chained launches")
        return k, plain_fn(), None

    return [("upblur4", f"chain_{label}", kf, pf, library_fwd, fwd_counts,
             lambda: check_chain(kf, chained, pf, "upblur4_bf16 chain")),
            ("upblur4_adj", f"chain_{label}", ka, pa, library_adj, adj_counts,
             lambda: check_chain(ka, chained_adj, pa, "upblur4_adj_bf16 cascade"))]


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


def phase_launch_times(torch, mods, per_kernel):
    """Launch-only times at batch 2 and 16 beside bound, plain and library
    times; the batch-16 sums over a kernel's shapes go into ``per_kernel``,
    those of its adjoint launches (``_adj``, ``_dx``) under ``adjoint_`` keys.
    Then the same in bf16 (``_bf16`` names): each bf16 kernel within BF16_TOL
    of max|plain| of its plain bf16 version, and within BF16_TOL of the max of
    the float32 plain version on the same bf16-rounded inputs (the bf16
    rounding is all that parts them).  The slice's backward is held to the
    float32 version only in print: its two ReLU masks, recomputed from values
    rounded to bf16 and from float32 ones, differ by whole terms wherever a
    pre-activation is within rounding of zero, and at the main path's shapes
    that is most 5x5 neighbourhoods.

    Each dtype also runs the 1024px main path's shapes (StyleGAN2 config-f,
    LPIPS-VGG16 on the 1024^2 image) at batch 2, held the same way, and every
    launch there twice: the two results must be bitwise equal (``torch.equal``:
    ``--remat`` runs each forward kernel again in the backward).  Their sums
    go under ``px1024_`` keys."""
    roof = mods[-1]
    bf = lambda t: t.bfloat16()  # noqa: E731
    for dtype in ("float32", "bfloat16"):
        for n, img in ((2, 256), (16, 256), (2, 1024)):
            def rnd_from(seed):
                if img == 1024:  # drawn on the card: the host would take tens of seconds for these sizes
                    g = torch.Generator(device="cuda").manual_seed(seed)
                    return lambda *shape, scale=1.0: torch.randn(shape, generator=g, device="cuda") * scale
                g = torch.Generator().manual_seed(seed)
                return lambda *shape, scale=1.0: (torch.randn(shape, generator=g) * scale).to("cuda")

            seed = n + (1000 if img == 1024 else 0)
            with torch.no_grad():
                if dtype == "float32":
                    cases = launch_cases(torch, mods, n, rnd_from(100 + seed), img_size=img)
                    refs = [None] * len(cases)
                else:
                    # the same draws twice: the bf16 cases, and float32 ones on the bf16-rounded inputs
                    cases = launch_cases(torch, mods, n, rnd_from(200 + seed), act=bf, img_size=img)
                    refs = launch_cases(torch, mods, n, rnd_from(200 + seed),
                                        act=lambda t: t.bfloat16().float(), img_size=img)
                for (name, shape, kfn, pfn, lfn, counts, chk), ref in zip(cases, refs):
                    kname = name + (BF16 if dtype == "bfloat16" else "")
                    line = {"phase": "launch", "kernel": kname, "shape": shape, "batch": n, "img_size": img,
                            "ms": median_ms(torch, kfn), "plain_ms": median_ms(torch, pfn),
                            "library_ms": median_ms(torch, lfn), **counts}
                    if shape.startswith("chain_"):  # the launches' host work hides the device time: both
                        line["back_to_back_ms"] = back_to_back_ms(torch, kfn)
                        line["device_ms"] = device_ms_per_call(torch, kfn, calls=10)
                    line["share_of_bound"] = line["bound_ms"] / line["ms"]
                    if img == 1024:  # two launches on one input: bitwise the same result
                        a, b = kfn(), kfn()
                        a, b = (a, b) if torch.is_tensor(a) else (torch.cat([t.flatten() for t in a]),
                                                                   torch.cat([t.flatten() for t in b]))
                        line["bitwise_deterministic"] = bool(torch.equal(a, b))
                        check(line["bitwise_deterministic"], f"{kname} {shape} batch {n}: two launches differ")
                        del a, b
                    if chk is not None:
                        k, p, keep = chk()
                        torch.cuda.synchronize()
                        diff = (k.float() - p.float()).abs()
                        if keep is not None:
                            line["left_out"] = int((~keep).sum().item())
                            check(line["left_out"] <= 0.01 * keep.numel(),
                                  f"{kname} {shape}: {line['left_out']} of {keep.numel()} values left out")
                            diff = diff * keep
                        err, pmax = diff.max().item(), p.float().abs().max().item()
                        check(bool(torch.isfinite(k).all()), f"{kname} {shape}: non-finite result")
                        if dtype == "float32":
                            scale = max(1.0, pmax)
                            check(err <= TOL * scale,
                                  f"{kname} {shape} batch {n}: error {err:.3e} > {TOL} * {scale:.3e}")
                        else:
                            check(k.dtype == torch.bfloat16 and err < BF16_TOL * pmax,
                                  f"{kname} {shape} batch {n}: error {err:.3e} >= {BF16_TOL} * {pmax:.3e}")
                            rk, rp, rkeep = ref[-1]()
                            rd = (k.float() - rp.float()).abs()
                            err32 = (rd * rkeep if rkeep is not None else rd).max().item()
                            line["max_abs_err_vs_float32_plain"] = err32
                            line["max_abs_float32_plain"] = rp.abs().max().item()
                            check(name == "vgg_slice1_bwd" or err32 < BF16_TOL * line["max_abs_float32_plain"],
                                  f"{kname} {shape} batch {n}: {err32:.3e} from the float32 plain version")
                            del rk, rp, rkeep, rd
                        line["max_abs_err"] = err
                        del k, p, keep, diff
                    emit(line)
                    agg = per_kernel.setdefault(("launch", kname), {"bound_by": {}, "err": 0.0})
                    if img == 1024:
                        agg["px1024_err"] = max(agg.get("px1024_err", 0.0), line.get("max_abs_err", 0.0))
                    else:
                        agg["err"] = max(agg["err"], line.get("max_abs_err", 0.0))
                    if n == 16 or img == 1024:
                        adjoint = shape.endswith(("_dx", "_adj"))
                        prefix = ("disc_" if shape.startswith("D_") else "") + ("adjoint_" if adjoint else "")
                        if shape.startswith("chain_"):  # the bf16 skip chain in one launch
                            prefix = "chain_"
                            for key in ("back_to_back_ms", "device_ms", "bound_by"):
                                agg[("px1024_" if img == 1024 else "") + "chain_" + key] = line[key]
                        if img == 1024:
                            prefix = "px1024_" + prefix
                        for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
                            agg[prefix + key] = agg.get(prefix + key, 0.0) + line[key]
                        if prefix in ("", "px1024_"):
                            by = agg.setdefault(prefix + "bound_by", {})
                            by[line["bound_by"]] = by.get(line["bound_by"], 0.0) + line["bound_ms"]
            del cases, refs
            torch.cuda.empty_cache()


def phase_recovery(torch, port, dtype="float32"):
    C, pl, attr = port["config"], port["pipeline"], port["attribute"]
    mcfg = C.ModelConfig(**TINY)
    fpcfg = C.FingerprintConfig(key_len=8, shift=56, n_pca_samples=2000)
    acfg = C.AttributionConfig(steps=300, n_starts=4, lr=0.2, loss="mse")
    # no device given: a library entry point runs on the card by default
    pipe = pl.build_pipeline(mcfg, fpcfg, generator=torch.Generator().manual_seed(TINY_SEED),
                             want_lpips=False)
    check(pipe.device.type == "cuda" and pipe.noise[0].is_cuda, f"default device {pipe.device}")
    imgs, _, _, bits, _ = pl.generate_fingerprinted(pipe, 3, torch.Generator().manual_seed(TINY_SEED + 1))
    t0 = time.time()
    port["_cuda"].reset_launches()
    res = attr.attribute(pipe.gen_params, None, pipe.basis, pipe.noise, imgs, mcfg=mcfg, acfg=acfg,
                         generator=torch.Generator().manual_seed(TINY_SEED + 2), dtype=dtype)
    torch.cuda.synchronize()
    if dtype == "bfloat16":
        for name in ("blur4", "upblur4", "upblur4_adj"):
            check(port["_cuda"].KERNELS[name + BF16].launches > 0 and port["_cuda"].KERNELS[name].launches == 0,
                  f"the bf16 mse solve did not run {name + BF16} alone")
    ev = attr.evaluate_attribution(res, bits)
    accs = [float(a) for a in ev["bit_acc"].cpu()]
    emit({"phase": "recovery", "dtype": dtype, "bit_acc": accs, "mean_bit_acc": sum(accs) / 3,
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


def of_dtype(counts, dtype: str = "float32"):
    """The entries of ``counts`` (by kernel name) that belong to ``dtype``'s kernels."""
    return {k: v for k, v in counts.items() if k.endswith(BF16) == (dtype == "bfloat16")}


@contextlib.contextmanager
def renders_counted(port):
    """Inside the block, the launches made within ``pipeline.synthesize`` (the
    float32 renders of targets and stored images, as in the reference) are
    summed by kernel into the yielded dict."""
    pl, cuda_mod = port["pipeline"], port["_cuda"]
    synthesize, inside = pl.synthesize, {name: 0 for name in cuda_mod.KERNELS}

    def counted(*args, **kwargs):
        before = cuda_mod.launch_counts()
        try:
            return synthesize(*args, **kwargs)
        finally:
            for name, n in cuda_mod.launch_counts().items():
                inside[name] += n - before[name]

    pl.synthesize = counted
    try:
        yield inside
    finally:
        pl.synthesize = synthesize


def check_bf16_solve(counts, renders, path: str, need=None) -> None:
    """A bf16 run's launches: its float32 kernels launched only by its float32
    renders (``renders_counted``), which launch no bf16 kernel; every bf16
    kernel in ``need`` (all of them if None) launched."""
    check(of_dtype(counts) == of_dtype(renders) and not any(of_dtype(renders, "bfloat16").values()),
          f"{path}: float32 launches {of_dtype(counts)} outside its float32 renders {renders}")
    for name, n in of_dtype(counts, "bfloat16").items():
        check(n > 0 or (need is not None and name not in need), f"kernel {name} was not launched by {path}")


def check_all_launched(counts, path: str, dtype: str = "float32") -> None:
    for name, n in of_dtype(counts, dtype).items():
        check(n > 0, f"kernel {name} was not launched by {path}")


# the header of the reference package's utils/profiling.py::format_report
PHASE_REPORT_HEADER = "phase                          count   total     mean"
# kernels whose names a traced full-width solve must hold (the LPIPS square convs, the synthesis blur)
TRACED_KERNELS = ("conv3x3_tc_kernel", "blur4_kernel")


def check_profile(text: str, run_dir: str, phases) -> dict:
    """What ``cli.attribute --profile`` printed and wrote: its phase report
    (the reference's header, one row per phase in ``phases``, each counted
    once) and one Chrome trace in ``<run_dir>/trace`` that names every kernel
    of ``TRACED_KERNELS``.  The trace (tens of MB) is deleted once checked."""
    lines = text.splitlines()
    check("[attribute] phase report:" in lines, "cli.attribute --profile printed no phase report")
    rows = lines[lines.index("[attribute] phase report:") + 1:]
    check(rows[0] == PHASE_REPORT_HEADER, f"phase report header {rows[0]!r}")
    check(sorted(r.split()[0] for r in rows[1:]) == sorted(phases) and all(r.split()[1] == "1" for r in rows[1:]),
          f"phase report rows {rows[1:]}, expected one each of {sorted(phases)}")
    trace_dir = os.path.join(run_dir, "trace")
    files = os.listdir(trace_dir)
    check(len(files) == 1, f"{trace_dir}: {files}")
    path = os.path.join(trace_dir, files[0])
    with open(path) as f:
        body = f.read()
    mentions = {k: body.count(k) for k in TRACED_KERNELS}
    check(all(mentions.values()), f"the trace names {mentions}")
    shutil.rmtree(trace_dir)
    return {"phase_report": rows, "trace_bytes": len(body), "trace_kernel_mentions": mentions}


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
    # the same run with half the steps: what a solve step launches is the difference; it runs
    # with --profile (tracing the solve changes no launch count).  The phase report is the
    # process's: the runs before this one recorded phases too
    cuda_mod.reset_launches()
    port["profiling"].report(reset=True)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        half_run = port["cli_attribute"].run(FULL + ["--loss", "perceptual", "--sample_size", str(samples),
                                                     "--n", str(starts), "--steps", str(steps // 2),
                                                     "--save_dir", save + "_half", "--profile"])
    half = cuda_mod.launch_counts()
    print(out.getvalue(), end="", flush=True)
    profile = check_profile(out.getvalue(), half_run.run_dir, ("build_pipeline", "generate_targets", "solve_chunk"))
    per_step = {}
    for name, n in of_dtype(counts).items():
        d, m = divmod(n - half[name], steps - steps // 2)
        check(m == 0, f"kernel {name}: {n} and {half[name]} launches over {steps} and {steps // 2} steps")
        want = port["roof"].LAUNCHES_PER_STEP[name]
        check(d == want, f"kernel {name}: {d} launches per solve step, the bound's table expects {want}")
        per_step[name] = d
    for f in ("result.txt", "sampling_config.yaml"):
        check(os.path.exists(os.path.join(r.run_dir, f)), f"missing {f}")
    check(all(v == v and abs(v) < float("inf") for v in r.losses), f"non-finite losses {r.losses}")
    check(len(r.bit_accs) == samples, "result rows")
    check_all_launched(counts, "the plain full-width solve")
    # 8 square convs in two orientations + the slice's w2 forward and its two adjoint convs, once each
    check(packs <= 19, f"{packs} weight packings over {steps} steps: weights are packed per call")
    line = {"phase": "attribute", "img_size": 256, "style_dim": 512, "n_mlp": 8, "channel_max": 512,
            "loss": "perceptual", "samples": samples, "restarts": starts, "steps": steps,
            "solve_seconds": r.solve_seconds, "steps_per_s": steps / r.solve_seconds,
            "chain_steps_per_s": steps * r.chains / r.solve_seconds,
            "max_memory_allocated_bytes": peak, "losses": r.losses, "bit_acc": r.bit_accs,
            "launches": counts, "launches_half_run": half, "launches_per_step": per_step,
            "weight_packings": packs, "half_run_profile": profile, "gpu": gpu}
    emit(line)
    return counts, per_step, line


def phase_step16(torch, port, gpu):
    """The 16-chain 256px perceptual solve step (4 targets x 4 restarts, full
    width) in float32 and in bf16, timed in the turns f32, bf16, bf16, f32
    (CUDA events, median of 5 steps after 2 warm-up steps a turn); for each
    dtype its peak memory, its launches per step (the dtype's kernels exactly
    ``roof.step_launches``, the other dtype's 0) and its device time by
    operation over 3 profiled steps, whose sum over the median step time is the
    device-busy share."""
    C, pl, attr, cuda_mod, roof = port["config"], port["pipeline"], port["attribute"], port["_cuda"], port["roof"]
    mcfg = C.ModelConfig(img_size=256)
    pipe = pl.build_pipeline(mcfg, C.FingerprintConfig(key_len=64, shift=448),
                             generator=torch.Generator().manual_seed(0))
    targets = torch.clamp(pl.generate_fingerprinted(pipe, 4, torch.Generator().manual_seed(1))[0], -1.0, 1.0)
    acfg = C.AttributionConfig(steps=20, n_starts=4, loss="perceptual")
    alpha0 = torch.as_tensor(port["lhs"].lhs_alpha_init_batch(4, 4, pipe.basis.sigma_rest,
                                                              torch.Generator().manual_seed(2)),
                             dtype=torch.float32).cuda()
    steps = {}
    for dtype in ("float32", "bfloat16"):
        feats, _ = attr._targets_for_loss(pipe.lpips_params, targets, acfg, dtype)
        steps[dtype] = attr.make_attribution_step(pipe.gen_params, pipe.lpips_params, pipe.basis, pipe.noise, mcfg,
                                                  acfg, feats, None, dtype=dtype)[0]
    holder = {}

    def one(dtype):
        holder[dtype], per = steps[dtype](holder[dtype])
        return per

    out = {}
    for dtype in ("float32", "bfloat16"):
        holder[dtype] = attr.init_state(alpha0, torch.zeros((4, 4, 64), device="cuda"))
        one(dtype)
        torch.cuda.synchronize()
        cuda_mod.reset_launches()
        per = one(dtype)
        torch.cuda.synchronize()
        counts = cuda_mod.launch_counts()
        other = "float32" if dtype == "bfloat16" else "bfloat16"
        want = roof.step_launches(dtype)
        check(of_dtype(counts, dtype) == want, f"{dtype} step launches {of_dtype(counts, dtype)}, expected {want}")
        check(all(v == 0 for v in of_dtype(counts, other).values()), f"{dtype} step launched {other} kernels: {counts}")
        check(bool(torch.isfinite(per).all()), f"{dtype} step: non-finite loss")
        out[dtype] = {"launches_per_step": of_dtype(counts, dtype), "loss_mean": float(per.mean()), "ms": []}
    for dtype in ("float32", "bfloat16", "bfloat16", "float32"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out[dtype]["ms"].append(median_ms(torch, lambda: one(dtype), reps=5, warmup=2))
        out[dtype]["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    for dtype in ("float32", "bfloat16"):
        by_kernel = device_kernel_ms(torch, lambda: one(dtype), calls=3)
        busy = sum(by_kernel.values())
        ms = statistics.median(out[dtype]["ms"])
        out[dtype].update({"ms_median": ms, "chain_steps_per_s": 16e3 / ms, "device_busy_ms": busy,
                           "device_busy_share": busy / ms,
                           "device_ms_top12": [[k[:90], v] for k, v in
                                               sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]]})
    emit({"phase": "step16", "img_size": 256, "style_dim": 512, "channel_max": 512, "chains": 16, "loss": "perceptual",
          **out, "bf16_speedup": out["float32"]["ms_median"] / out["bfloat16"]["ms_median"], "gpu": gpu})
    return out["bfloat16"]["launches_per_step"]


def phase_attribute_bf16(torch, port, gpu, f32_line):
    """``cli.attribute --dtype bfloat16`` as phase 5 runs it (full width,
    perceptual, 2 samples x 4 restarts, 20 steps)."""
    cuda_mod = port["_cuda"]
    steps, samples, starts = 20, 2, 4
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_mod.reset_launches()
    with renders_counted(port) as renders:
        r = port["cli_attribute"].run(FULL + ["--loss", "perceptual", "--sample_size", str(samples), "--n",
                                              str(starts), "--steps", str(steps), "--dtype", "bfloat16",
                                              "--save_dir", os.path.join(OUT, "attribute_bf16")])
    counts = cuda_mod.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check(os.path.exists(os.path.join(r.run_dir, "result.txt")), "cli.attribute --dtype bfloat16: no result.txt")
    check(len(r.bit_accs) == samples and all(v == v and abs(v) < float("inf") for v in r.losses),
          f"rows {r.bit_accs}, losses {r.losses}")
    check_bf16_solve(counts, renders, "cli.attribute --dtype bfloat16")
    # the same run with half the steps: a bf16 solve step launches what the bound's table says
    cuda_mod.reset_launches()
    port["cli_attribute"].run(FULL + ["--loss", "perceptual", "--sample_size", str(samples), "--n", str(starts),
                                      "--steps", str(steps // 2), "--dtype", "bfloat16",
                                      "--save_dir", os.path.join(OUT, "attribute_bf16_half")])
    half, want = cuda_mod.launch_counts(), port["roof"].step_launches("bfloat16")
    per_step = {}
    for name, n in of_dtype(counts, "bfloat16").items():
        d, m = divmod(n - half[name], steps - steps // 2)
        check(m == 0 and d == want[name], f"cli.attribute --dtype bfloat16: {name} {n} and {half[name]} launches "
                                          f"over {steps} and {steps // 2} steps, the table expects {want[name]} a step")
        per_step[name] = d
    emit({"phase": "attribute_bf16", "img_size": 256, "loss": "perceptual", "dtype": "bfloat16", "samples": samples,
          "restarts": starts, "steps": steps, "solve_seconds": r.solve_seconds,
          "chain_steps_per_s": steps * r.chains / r.solve_seconds, "max_memory_allocated_bytes": peak,
          "float32_chain_steps_per_s": f32_line["chain_steps_per_s"],
          "float32_max_memory_allocated_bytes": f32_line["max_memory_allocated_bytes"],
          "losses": r.losses, "bit_acc": r.bit_accs, "launches": counts, "launches_per_step": per_step, "gpu": gpu})
    return counts


FULL_1024 = ["--device", "cuda", "--random_init", "--img_size", "1024", "--key_len", "64", "--shift", "448"]
# (dtype, remat) of the 1024px cli.attribute runs; (dtype, remat, remat_lpips) of the direct solve steps
RUNS_1024 = (("float32", False), ("float32", True), ("bfloat16", True))
STEPS_1024 = (("float32", False, False), ("float32", True, False), ("float32", True, True),
              ("bfloat16", False, False), ("bfloat16", True, False))
REMAT_LOSS_RTOL = 1e-6  # step-1 losses with and without gradient checkpointing


def feature_launches(roof, dtype: str, img_size: int) -> dict:
    """Launches of one LPIPS feature extraction without a backward (the targets')."""
    sfx = BF16 if dtype == "bfloat16" else ""
    return {"conv3x3_relu" + sfx: sum(k for _, _, k in roof.conv3x3_shapes(img_size)), "vgg_slice1_fwd" + sfx: 1}


def rel_diff(torch, a, b) -> float:
    return float(((a.float() - b.float()).abs() / b.float().abs().clamp_min(1e-30)).max())


def phase_attribute_1024(torch, port, gpu):
    """The main path at 1024 px: StyleGAN2 config-f (style_dim 512, n_mlp 8,
    channel_multiplier 2, channel_max 512, 18 W+ slots) from ``--random_init``,
    LPIPS-VGG16 on the 1024^2 image.  ``cli.generate`` writes its PNGs; the
    perceptual solve step alone at 4 and 8 chains for each of ``STEPS_1024``
    (peak memory of a step after a warm-up one, the largest chain count that
    fits the card by a line through the two peaks, the median of 3 steps by
    CUDA events, its launches per step held to ``roof.step_launches(dtype,
    1024, remat, remat_lpips)``; the step-1 losses of every checkpointed
    variant within ``REMAT_LOSS_RTOL`` of its dtype's plain step, a lower peak
    with ``remat``); then ``cli.attribute`` for each of ``RUNS_1024`` (2 x 4
    chains, 10 steps): every kernel of its dtype launched, and its launches
    outside the float32 renders and the targets' features ten solve steps'."""
    C, pl, attr, cuda_mod, roof = port["config"], port["pipeline"], port["attribute"], port["_cuda"], port["roof"]
    from PIL import Image
    import numpy as np

    t0 = time.time()
    save = os.path.join(OUT, "generate_1024")
    rc = port["cli_generate"].main(FULL_1024 + ["--sample_size", "2", "--save_dir", save])
    check(rc == 0, f"cli.generate at 1024 px returned {rc}")
    for folder in ("original", "watermarked"):
        d = [os.path.join(dp, f) for dp, _, fs in os.walk(save) for f in fs
             if f.endswith(".png") and os.path.basename(dp) == folder]
        check(len(d) == 2, f"1024 px {folder}: {len(d)} PNGs")
        for f in d:
            a = np.asarray(Image.open(f))
            check(a.shape == (1024, 1024, 3) and a.std() > 1.0, f"{f}: shape {a.shape}, std {a.std():.2f}")
    generate_seconds = time.time() - t0

    mcfg = C.ModelConfig(img_size=1024)
    pipe = pl.build_pipeline(mcfg, C.FingerprintConfig(key_len=64, shift=448),
                             generator=torch.Generator().manual_seed(0))
    targets = torch.clamp(pl.generate_fingerprinted(pipe, 2, torch.Generator().manual_seed(1))[0], -1.0, 1.0)
    acfg = C.AttributionConfig(steps=10, n_starts=4, loss="perceptual")
    alpha0 = torch.as_tensor(port["lhs"].lhs_alpha_init_batch(2, 4, pipe.basis.sigma_rest,
                                                              torch.Generator().manual_seed(2)),
                             dtype=torch.float32).cuda()
    capacity = torch.cuda.get_device_properties(0).total_memory
    steps = {}
    first = {}  # (dtype, tag) -> the step-1 and step-2 losses at 8 chains
    for dtype, remat, remat_lpips in STEPS_1024:
        tag = dtype + ("_remat" if remat else "") + ("_lpips" if remat_lpips else "")
        rec = {"dtype": dtype, "remat": remat, "remat_lpips": remat_lpips}
        for chains in (4, 8):
            s_ = chains // 4
            feats, _ = attr._targets_for_loss(pipe.lpips_params, targets[:s_], acfg, dtype)
            step = attr.make_attribution_step(pipe.gen_params, pipe.lpips_params, pipe.basis, pipe.noise, mcfg,
                                              acfg, feats, None, dtype=dtype, remat=remat,
                                              remat_lpips=remat_lpips)[0]
            holder = {"state": attr.init_state(alpha0[:s_], torch.zeros((s_, 4, 64), device="cuda"))}

            def one():
                holder["state"], per = step(holder["state"])
                return per

            torch.cuda.synchronize()
            cuda_mod.reset_launches()
            per1 = one()  # warm-up: the weight packings are made here
            torch.cuda.synchronize()
            counts = cuda_mod.launch_counts()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            per2 = one()
            torch.cuda.synchronize()
            rec[f"peak_bytes_{chains}_chains"] = torch.cuda.max_memory_allocated()
            check(bool(torch.isfinite(per1).all() and torch.isfinite(per2).all()), f"{tag}: non-finite loss")
            if chains == 8:
                want = roof.step_launches(dtype, 1024, remat, remat_lpips)
                other = "float32" if dtype == "bfloat16" else "bfloat16"
                check(of_dtype(counts, dtype) == want and not any(of_dtype(counts, other).values()),
                      f"1024 px {tag} step launches {counts}, expected {want}")
                rec["launches_per_step"] = of_dtype(counts, dtype)
                rec["ms"] = median_ms(torch, one, reps=3, warmup=0)
                first[tag] = (per1.detach(), per2.detach())
            del step, holder, feats, per1, per2
            torch.cuda.empty_cache()
        p4, p8 = rec["peak_bytes_4_chains"], rec["peak_bytes_8_chains"]
        per_chain = (p8 - p4) / 4
        rec.update(bytes_per_chain=per_chain, fixed_bytes=p4 - 4 * per_chain, capacity_bytes=capacity,
                   max_chains=int((capacity - (p4 - 4 * per_chain)) // per_chain) if per_chain > 0 else None,
                   chain_steps_per_s=8e3 / rec["ms"])
        steps[tag] = rec
    for tag, (a1, a2) in first.items():
        base = tag.split("_")[0]
        if tag == base:
            continue
        b1, b2 = first[base]
        steps[tag]["step1_loss_rel_diff"] = rel_diff(torch, a1, b1)
        steps[tag]["step2_loss_rel_diff"] = rel_diff(torch, a2, b2)
        check(steps[tag]["step1_loss_rel_diff"] <= REMAT_LOSS_RTOL,
              f"{tag}: step-1 losses {steps[tag]['step1_loss_rel_diff']:.2e} from {base}'s")
        peak, base_peak = steps[tag]["peak_bytes_8_chains"], steps[base]["peak_bytes_8_chains"]
        check(peak < base_peak, f"{tag}: peak {peak} not below {base}'s {base_peak}")
    emit({"phase": "attribute_1024_steps", "img_size": 1024, "chains": 8, "loss": "perceptual", "steps": steps,
          "gpu": gpu})
    del pipe, targets, alpha0
    torch.cuda.empty_cache()

    runs, launched = {}, {}
    for dtype, remat in RUNS_1024:
        tag = dtype + ("_remat" if remat else "")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda_mod.reset_launches()
        with renders_counted(port) as renders:
            r = port["cli_attribute"].run(FULL_1024 + ["--loss", "perceptual", "--sample_size", "2", "--n", "4",
                                                       "--steps", "10", "--dtype", dtype,
                                                       "--save_dir", os.path.join(OUT, "attribute_1024_" + tag)]
                                          + (["--remat"] if remat else []))
        counts = cuda_mod.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        check(os.path.exists(os.path.join(r.run_dir, "result.txt")) and len(r.bit_accs) == 2
              and all(v == v and abs(v) < float("inf") for v in r.losses), f"1024 px {tag}: {r.losses}")
        if dtype == "bfloat16":
            check_bf16_solve(counts, renders, f"cli.attribute 1024 px {tag}")
        else:
            check_all_launched(counts, f"cli.attribute 1024 px {tag}")
        feat = feature_launches(roof, dtype, 1024)
        solve = {k: v - renders[k] - feat.get(k, 0) for k, v in of_dtype(counts, dtype).items()}
        want = {k: 10 * v for k, v in roof.step_launches(dtype, 1024, remat).items()}
        check(solve == want, f"1024 px {tag}: solve launches {solve}, expected {want}")
        launched[tag] = counts
        runs[tag] = {"solve_seconds": r.solve_seconds, "chain_steps_per_s": 10 * r.chains / r.solve_seconds,
                     "max_memory_allocated_bytes": peak, "losses": r.losses, "bit_acc": r.bit_accs,
                     "launches": counts, "solve_launches": solve}
    runs["float32_remat"]["loss_rel_diff_vs_float32"] = max(
        abs(a - b) / abs(b) for a, b in zip(runs["float32_remat"]["losses"], runs["float32"]["losses"]))
    emit({"phase": "attribute_1024", "img_size": 1024, "style_dim": 512, "n_mlp": 8, "channel_max": 512,
          "loss": "perceptual", "samples": 2, "restarts": 4, "steps": 10, "runs": runs,
          "generate_seconds": generate_seconds, "seconds": time.time() - t0, "gpu": gpu})
    return launched, {tag: rec["launches_per_step"] for tag, rec in steps.items()}


def phase_attacks(torch, port):
    import math

    atk, C = port["attacks"], port["config"]
    g = torch.Generator().manual_seed(7)
    yy, xx = torch.meshgrid(torch.linspace(-1, 1, 256), torch.linspace(-1, 1, 256), indexing="ij")
    base = torch.stack([torch.sin(3 * xx + p) * torch.cos(2 * yy - p) for p in (0.0, 1.0, 2.0)], -1)
    x_cpu = torch.clamp(0.8 * base[None] + 0.25 * torch.randn((2, 256, 256, 3), generator=g), -1.0, 1.0)
    x = x_cpu.cuda()
    unit = torch.randn(x_cpu.shape, generator=g)
    for name in ("Noise", "Blur", "Jpeg", "Crop", "Combination"):
        cfg = C.AttackConfig(augmentation=name)
        attack, solver = atk.make_attack(cfg), atk.make_solver_attack(cfg, name)
        line = {"phase": "attacks", "attack": name}
        got, want = atk.apply_attack(attack, x, noise=unit).cpu(), atk.apply_attack(attack, x_cpu, noise=unit)
        check(got.shape == x_cpu.shape and bool(torch.isfinite(got).all()), f"{name}: shape or non-finite")
        diff = (got - want).abs()
        if name in ("Jpeg", "Combination"):  # hard rounding: count, do not take a max
            line["share_within_2e-4"] = float((diff <= 2e-4).float().mean())
            check(line["share_within_2e-4"] >= 0.999, f"{name}: {line['share_within_2e-4']:.5f} of pixels agree")
        else:
            line["max_abs_err"] = float(diff.max())
            check(line["max_abs_err"] <= 1e-5, f"{name}: card vs CPU {line['max_abs_err']:.3e}")
        xr, xc = x.clone().requires_grad_(True), x_cpu.clone().requires_grad_(True)
        ys, yc = solver(xr), solver(xc)
        tol = 2e-4 if name in ("Jpeg", "Combination") else 1e-5
        line["solver_max_abs_err"] = float((ys.detach().cpu() - yc.detach()).abs().max())
        check(line["solver_max_abs_err"] <= tol, f"{name} solver attack: card vs CPU {line['solver_max_abs_err']:.3e}")
        (grad,) = torch.autograd.grad(ys.sum(), xr)
        check(bool(torch.isfinite(grad).all()), f"{name} solver attack: non-finite gradient")
        line["solver_grad_abs_max"] = float(grad.abs().max())
        check(math.isfinite(line["solver_grad_abs_max"]) and line["solver_grad_abs_max"] > 0, f"{name}: zero gradient")
        emit(line)


def phase_robust_recovery(torch, port):
    """Blur-attacked targets of the tiny configuration, solved attack-aware."""
    C, pl, attr, lhs = port["config"], port["pipeline"], port["attribute"], port["lhs"]
    mcfg = C.ModelConfig(**TINY)
    fpcfg = C.FingerprintConfig(key_len=8, shift=56, n_pca_samples=2000)
    acfg_kw = dict(steps=300, n_starts=4, lr=0.2, loss="mse", solver_attack="Blur")
    atk_cfg = C.AttackConfig(augmentation="Blur")
    pipe = pl.build_pipeline(mcfg, fpcfg, generator=torch.Generator().manual_seed(TINY_SEED),
                             want_lpips=False, attack_cfg=atk_cfg)
    imgs, _, _, bits, _ = pl.generate_fingerprinted(pipe, 3, torch.Generator().manual_seed(TINY_SEED + 1))
    # unclamped, as phase 3 takes them: the random tiny generator leaves [-1, 1], and the
    # solver's estimate is not clamped, so only then is the planted key an exact solution
    targets = pl.augment(pipe, imgs)
    check(float((targets - imgs).abs().max()) > 1e-3, "the Blur attack left the targets unchanged")
    alpha0 = lhs.lhs_alpha_init_batch(3, 4, pipe.basis.sigma_rest, torch.Generator().manual_seed(TINY_SEED + 2))
    results = {}
    for label, extra, chunk in (("attack_aware", {}, 0), ("chunk_starts_2", {}, 2),
                                ("pruned_polished", dict(prune_starts=2, prune_frac=0.5, polish_sweeps=1), 0)):
        t0 = time.time()
        res = attr.attribute_chunked(pipe.gen_params, None, pipe.basis, pipe.noise, targets, mcfg=mcfg,
                                     acfg=C.AttributionConfig(**acfg_kw, **extra), chunk_starts=chunk,
                                     attack_cfg=atk_cfg, alpha_init=alpha0)
        torch.cuda.synchronize()
        accs = [float(a) for a in attr.evaluate_attribution(res, bits)["bit_acc"].cpu()]
        results[label] = res
        emit({"phase": "robust", "run": label, "bit_acc": accs, "exact": sum(a >= 1.0 for a in accs),
              "loss": [float(v) for v in res.loss.cpu()], "best_start": res.best_start.cpu().tolist(),
              "restarts_at_the_end": res.losses_all.shape[1], "seconds": time.time() - t0})
        check(sum(accs) / 3 > 0.85, f"{label}: mean bit accuracy {sum(accs) / 3:.3f} <= 0.85")
        check(sum(a >= 1.0 for a in accs) >= 2, f"{label}: fewer than 2 of 3 keys exact: {accs}")
    whole, parts = results["attack_aware"], results["chunk_starts_2"]
    check(torch.equal(whole.key_bits, parts.key_bits), "chunked restarts changed the key bits")
    check(torch.equal(whole.best_start, parts.best_start),
          f"chunked restarts changed the best start: {whole.best_start.tolist()} vs {parts.best_start.tolist()}")
    check(results["pruned_polished"].losses_all.shape == (3, 2), "pruning kept another number of restarts")


def phase_attacked_attribute(torch, port, gpu):
    """The attacked, attack-aware, pruned, polished, chunked full-width solve, then
    the same run cut after its first sample chunk and finished with --resume."""
    cuda_mod, state_mod = port["_cuda"], port["state"]
    steps, samples, starts, keep = 20, 2, 4, 2
    flags = FULL + ["--loss", "perceptual", "--sample_size", str(samples), "--n", str(starts), "--steps", str(steps),
                    "--augmentation", "Jpeg", "--attack_aware", "--prune_starts", str(keep), "--polish_sweeps", "1",
                    "--chunk_samples", "1"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_mod.reset_launches()
    r = port["cli_attribute"].run(flags + ["--save_dir", os.path.join(OUT, "attacked")])
    counts = cuda_mod.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check_all_launched(counts, "the attacked full-width solve")
    want_steps = samples * port["attribute"].executed_chain_steps(steps, starts, keep, 0.25)
    check(r.chain_steps == want_steps, f"{r.chain_steps} chain-steps counted, {want_steps} expected")
    check(len(r.bit_accs) == samples and all(v == v and abs(v) < float("inf") for v in r.losses),
          f"rows {r.bit_accs}, losses {r.losses}")

    torch.backends.cudnn.deterministic = True
    try:
        whole = port["cli_attribute"].run(flags + ["--save_dir", os.path.join(OUT, "attacked_whole")])
        st, arrays = state_mod.load_state(whole.run_dir)
        check(st.next_sample == samples and arrays["recovered_bits"].shape == (samples, 64)
              and arrays["losses_all"].shape == (samples, keep), "saved state of the finished run")
        # what a run killed after its first chunk leaves: cursor at 1, one row in every array
        cut = os.path.join(OUT, "attacked_cut")
        shutil.copytree(whole.run_dir, cut)
        os.remove(os.path.join(cut, "result.txt"))
        st.next_sample, st.bit_accs, st.success = 1, st.bit_accs[:1], int(st.bit_accs[0] >= 1.0)
        state_mod.save_state(cut, st, {k: (v[:1] if v.ndim else v) for k, v in arrays.items()})
        cuda_mod.reset_launches()
        r2 = port["cli_attribute"].run(["--device", "cuda", "--resume", cut, "--chunk_samples", "1"])
        resumed_counts = cuda_mod.launch_counts()
    finally:
        torch.backends.cudnn.deterministic = False
    check_all_launched(resumed_counts, "the resumed solve")
    results = [open(os.path.join(d, "result.txt")).read() for d in (whole.run_dir, cut)]
    check(results[0] == results[1], f"resumed result.txt differs:\n{results[0]}\nvs\n{results[1]}")
    check(r2.bit_accs == whole.bit_accs and r2.losses == whole.losses[1:], "resumed rows")
    emit({"phase": "attacked", "img_size": 256, "style_dim": 512, "n_mlp": 8, "channel_max": 512,
          "loss": "perceptual", "augmentation": "Jpeg", "attack_aware": True, "samples": samples,
          "restarts": starts, "prune_starts": keep, "polish_sweeps": 1, "chunk_samples": 1, "steps": steps,
          "solve_seconds": r.solve_seconds, "executed_chain_steps": r.chain_steps,
          "chain_steps_per_s": r.chain_steps / r.solve_seconds, "max_memory_allocated_bytes": peak,
          "losses": r.losses, "bit_acc": r.bit_accs, "launches": counts,
          "deterministic_cudnn": {"whole_solve_seconds": whole.solve_seconds, "losses": whole.losses,
                                  "resumed_solve_seconds": r2.solve_seconds,
                                  "resumed_executed_chain_steps": r2.chain_steps,
                                  "result_txt_equal": True, "resumed_launches": resumed_counts}, "gpu": gpu})
    return counts


def device_kernel_ms(torch, fn, calls: int = 3) -> dict:
    """Device time of ``fn`` per call by CUDA kernel name (the kernels' self
    times under ``torch.profiler``), ms."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = getattr(e, "self_cuda_time_total", 0.0)
        if dev > 0 and str(getattr(e, "device_type", "")).endswith("CUDA"):
            out[e.key] = out.get(e.key, 0.0) + dev / 1e3 / calls
    return out


def device_ms_per_call(torch, fn, calls: int = 3) -> float:
    """Device time of ``fn`` (the sum of its CUDA kernels' self times), per call."""
    return sum(device_kernel_ms(torch, fn, calls).values())


def phase_encoder(torch, port, gpu):
    """(a) The encoder: 200 training steps at full width and 256px on the Jpeg
    channel (batch 16 = auto_batch(256)), its device time split between the
    render and the encoder's step, a few steps at batch 64 for the memory;
    then 400 steps on the tiny configuration, whose decode and encoder-init
    solve are held to the reference's criteria."""
    C, pl, enc, attr, cuda_mod = port["config"], port["pipeline"], port["encoder"], port["attribute"], port["_cuda"]
    mcfg = C.ModelConfig(img_size=256)
    atk = C.AttackConfig(augmentation="Jpeg")
    pipe = pl.build_pipeline(mcfg, C.FingerprintConfig(key_len=64, shift=448),
                             generator=torch.Generator().manual_seed(0), want_lpips=False, attack_cfg=atk)
    batch = enc.auto_batch(256)
    check(batch == 16, f"auto_batch(256) = {batch}")
    ecfg = enc.EncoderConfig(batch=batch)
    steps = 200
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_mod.reset_launches()
    t0 = time.time()
    params, curve = enc.train_encoder(pipe.gen_params, pipe.basis, pipe.noise, mcfg=mcfg, ecfg=ecfg,
                                      attack="Jpeg", attack_cfg=atk, generator=torch.Generator().manual_seed(1),
                                      steps_override=steps)
    torch.cuda.synchronize()
    dt = time.time() - t0
    counts = cuda_mod.launch_counts()
    peak16 = torch.cuda.max_memory_allocated()
    check(curve.shape == (steps,) and bool(torch.isfinite(curve).all()), "non-finite encoder loss")
    first, last = float(curve[:10].mean()), float(curve[-20:].mean())
    check(last < first, f"encoder loss did not fall: first 10 {first:.4f}, last 20 {last:.4f}")
    for name in ("blur4_bf16", "upblur4_bf16"):  # the render goes through a bf16 w+
        check(counts[name] > 0, f"kernel {name} was not launched by encoder training")
    # a render a step, its skip chain one launch (roof.step_launches("bfloat16")), no backward through it
    chain = port["roof"].step_launches("bfloat16")["upblur4_bf16"]
    check(counts["upblur4_bf16"] == steps * chain and counts["upblur4_adj_bf16"] == 0,
          f"encoder training: {counts['upblur4_bf16']} upblur4_bf16 launches over {steps} renders")

    # where a step's device time goes: the render (generator forward + Jpeg) vs the
    # encoder's forward + backward + clipped Adam, each profiled alone on fixed inputs
    g = torch.Generator().manual_seed(2)
    attack_fn = port["attacks"].make_attack(atk)
    imgs, alpha, bits = enc.render(pipe.gen_params, pipe.basis, pipe.noise, mcfg, batch, g, attack_fn)
    opt = enc.init_opt_state(params)
    render_ms = device_ms_per_call(
        torch, lambda: enc.render(pipe.gen_params, pipe.basis, pipe.noise, mcfg, batch, g, attack_fn))
    step_ms = device_ms_per_call(
        torch, lambda: enc.train_step(params, opt, imgs, alpha, bits, pipe.basis.sigma_rest, ecfg))

    torch.cuda.reset_peak_memory_stats()
    enc.train_encoder(pipe.gen_params, pipe.basis, pipe.noise, mcfg=mcfg, ecfg=enc.EncoderConfig(batch=64),
                      attack="Jpeg", attack_cfg=atk, generator=torch.Generator().manual_seed(3), steps_override=3)
    torch.cuda.synchronize()
    peak64 = torch.cuda.max_memory_allocated()
    emit({"phase": "encoder", "img_size": 256, "style_dim": 512, "n_mlp": 8, "channel_max": 512,
          "augmentation": "Jpeg", "batch": batch, "steps": steps, "seconds": dt, "steps_per_s": steps / dt,
          "images_per_s": steps * batch / dt, "loss_first10": first, "loss_last20": last,
          "max_memory_allocated_bytes_batch16": peak16, "max_memory_allocated_bytes_batch64": peak64,
          "device_ms_render": render_ms, "device_ms_encoder_step": step_ms, "launches": counts, "gpu": gpu})

    # the tiny configuration at the reference's budget, with cuDNN held to its
    # deterministic algorithms: with the default ones the encoder's weight
    # gradients are summed in another order every run, and a weak encoder's
    # logits decide which bits its solve starts on (tools/encoder_tiny_spread.py)
    torch.backends.cudnn.deterministic = True
    try:
        tiny = encoder_tiny(torch, port)
    finally:
        torch.backends.cudnn.deterministic = False
    emit(tiny)
    decode, acc_enc, acc_lhs = tiny["zero_step_decode_256"], tiny["bit_acc_encoder_init"], tiny["bit_acc_lhs"]
    check(decode > 0.55, f"zero-step decode {decode:.3f} <= 0.55")
    check(acc_enc >= acc_lhs - 1.0 / 8, f"encoder-init solve {acc_enc:.3f} worse than LHS {acc_lhs:.3f} by > 1 bit")
    return counts


def encoder_tiny(torch, port) -> dict:
    """The encoder on the tiny configuration at the reference's budget (400 steps
    at batch 16), the generator from seed 0 as there: its zero-step decode, read
    over 256 samples (a weak signal, about 0.59 on the CPU), and the
    encoder-init solve beside the LHS solve (150 mse steps, 4 restarts) on 3
    samples.  Returns phase 9's ``encoder_tiny`` line; the caller holds it to
    the reference's criteria."""
    C, pl, enc, attr = port["config"], port["pipeline"], port["encoder"], port["attribute"]
    t0 = time.time()
    tmcfg = C.ModelConfig(**TINY)
    tpipe = pl.build_pipeline(tmcfg, C.FingerprintConfig(key_len=8, shift=56, n_pca_samples=2000),
                              generator=torch.Generator().manual_seed(0), want_lpips=False)
    tparams, tcurve = enc.train_encoder(
        tpipe.gen_params, tpipe.basis, tpipe.noise, mcfg=tmcfg,
        ecfg=enc.EncoderConfig(width=32, max_width=64, head_dim=64, steps=400, batch=16),
        generator=torch.Generator().manual_seed(4))
    imgs_d, _, _, bits_d, _ = pl.generate_fingerprinted(tpipe, 256, torch.Generator().manual_seed(12))
    decode = float(enc.encoder_bit_accuracy(tparams, imgs_d, bits_d).mean())
    imgs3, _, _, bits3, _ = pl.generate_fingerprinted(tpipe, 3, torch.Generator().manual_seed(21))
    acfg = C.AttributionConfig(steps=150, n_starts=4, lr=0.2, loss="mse")
    a0, k0 = enc.encoder_solve_init(tparams, tpipe.basis, imgs3, 4, torch.Generator().manual_seed(22))
    res_enc = attr.attribute(tpipe.gen_params, None, tpipe.basis, tpipe.noise, imgs3, mcfg=tmcfg, acfg=acfg,
                             alpha_init=a0, key_init=k0)
    res_lhs = attr.attribute(tpipe.gen_params, None, tpipe.basis, tpipe.noise, imgs3, mcfg=tmcfg, acfg=acfg,
                             generator=torch.Generator().manual_seed(23))
    return {"phase": "encoder_tiny", "steps": 400, "batch": 16, "loss_first10": float(tcurve[:10].mean()),
            "loss_last20": float(tcurve[-20:].mean()), "zero_step_decode_256": decode, "solve_steps": 150,
            "bit_acc_encoder_init": float(attr.evaluate_attribution(res_enc, bits3)["mean_bit_acc"]),
            "bit_acc_lhs": float(attr.evaluate_attribution(res_lhs, bits3)["mean_bit_acc"]),
            "loss_encoder_init": [float(v) for v in res_enc.loss.cpu()],
            "loss_lhs": [float(v) for v in res_lhs.loss.cpu()],
            "cudnn_deterministic": bool(torch.backends.cudnn.deterministic), "seconds": time.time() - t0}


def phase_attribute_encoder(torch, port, gpu):
    """(b) ``cli.attribute --init encoder`` at full width on the Jpeg channel, attack-aware."""
    import io

    cuda_mod = port["_cuda"]
    flags = FULL + ["--loss", "perceptual", "--sample_size", "2", "--n", "4", "--steps", "20",
                    "--augmentation", "Jpeg", "--attack_aware", "--init", "encoder", "--encoder_steps", "100",
                    "--save_dir", os.path.join(OUT, "attribute_encoder"), "--profile"]
    cuda_mod.reset_launches()
    port["profiling"].report(reset=True)
    out = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(out):
        r = port["cli_attribute"].run(flags)
    seconds = time.time() - t0
    counts = cuda_mod.launch_counts()
    text = out.getvalue()
    print(text, end="", flush=True)
    lines = [ln for ln in text.splitlines() if "encoder trained in" in ln and "zero-step decode bit acc" in ln]
    check(len(lines) == 1, "cli.attribute --init encoder printed no encoder line")
    check(os.path.exists(os.path.join(r.run_dir, "result.txt")), "missing result.txt")
    check(len(r.bit_accs) == 2 and all(v == v and abs(v) < float("inf") for v in r.losses),
          f"rows {r.bit_accs}, losses {r.losses}")
    check_all_launched(counts, "cli.attribute --init encoder")
    profile = check_profile(text, r.run_dir, ("build_pipeline", "generate_targets", "train_encoder", "solve_chunk"))
    emit({"phase": "attribute_encoder", "encoder_line": lines[0], "seconds": seconds, "profile": profile,
          "solve_seconds": r.solve_seconds, "chain_steps_per_s": r.chain_steps / r.solve_seconds,
          "bit_acc": r.bit_accs, "losses": r.losses, "launches": counts, "gpu": gpu})
    return counts


def _http(method, url, payload=None):
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, method=method, headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        body = json.loads(r.read())
        check(r.status == 200, f"{url}: HTTP {r.status}")
    return body, (time.perf_counter() - t0) * 1e3


# A burst of concurrent POSTs from a process of its own, as remote clients would
# send them: in the server's process the clients' JSON work would hold its GIL.
_CLIENT = r"""
import json, sys, time, urllib.request
from concurrent.futures import ThreadPoolExecutor
url, payloads = json.load(sys.stdin)
def post(p):
    req = urllib.request.Request(url, data=json.dumps(p).encode(), headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        body = json.loads(r.read())
    return {"ms": (time.perf_counter() - t0) * 1e3, "key_bits": body["key_bits"], "image": body.get("image")}
t0 = time.perf_counter()
with ThreadPoolExecutor(len(payloads)) as ex:
    out = list(ex.map(post, payloads))
print(json.dumps({"wall_s": time.perf_counter() - t0, "replies": out}))
"""


def _burst(url, payloads):
    r = run_child([sys.executable, "-c", _CLIENT], 600, input=json.dumps([url, payloads]))
    check(r.returncode == 0, f"client process failed: {r.stderr[-2000:]}")
    return json.loads(r.stdout)


def _pcts(ms):
    ms = sorted(ms)
    return {"n": len(ms), "p50_ms": ms[len(ms) // 2], "p99_ms": ms[min(len(ms) - 1, int(len(ms) * 0.99))]}


def phase_serve(torch, port, gpu):
    """(c) ``cli.serve`` at full width (buckets 1 and 4, perceptual, 20 steps,
    4 restarts, encoder init of 100 steps, a 16-user registry) on port 0:
    concurrent generation from a client process, attribution,
    identification, stats; the engine's own batch times; then the tiny
    configuration served, where identify must name the planted users."""
    import base64
    import io

    import numpy as np

    keys_mod, serving, cuda_mod = port["keys"], port["serving"], port["_cuda"]
    reg_path = os.path.join(OUT, "registry16.json")
    key_len = int(FULL[FULL.index("--key_len") + 1])
    reg = keys_mod.KeyRegistry.issue(16, key_len, min_distance=key_len // 4, seed=0)
    reg.save(reg_path)
    t0 = time.time()
    engine, server = port["cli_serve"].build_server(
        FULL + ["--loss", "perceptual", "--steps", "20", "--n", "4", "--buckets", "1,4", "--port", "0",
                "--init", "encoder", "--encoder_steps", "100", "--registry", reg_path])
    startup = time.time() - t0
    serving.serve_forever_in_thread(server)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    lat = {"attribute": [], "identify": [], "stats": []}
    try:
        check(engine.stats()["compiled"] == ["attribute:1", "attribute:4", "generate:1", "generate:4"],
              f"warmed buckets {engine.stats()['compiled']}")
        cuda_mod.reset_launches()
        solo, solo_ms = _http("POST", base + "/v1/generate", {"seed": 100, "encoding": "float_list"})
        before = engine.stats()["generate"]["batches"]
        reqs = [{"seed": 100 + i, "encoding": "float_list"} if i % 2 == 0 else
                {"seed": 100 + i, "user": reg.names[i]} for i in range(8)]
        burst8 = _burst(base + "/v1/generate", reqs)
        batches = engine.stats()["generate"]["batches"] - before
        check(batches < 8, f"8 concurrent requests ran as {batches} batches: nothing coalesced")
        for i, reply in enumerate(burst8["replies"]):
            if "user" in reqs[i]:
                check(reply["key_bits"] == reg.keys[i].tolist(), f"user {reg.names[i]}: planted key not returned")
        http_same = float(np.abs(np.asarray(burst8["replies"][0]["image"]) - np.asarray(solo["image"])).max())
        check(http_same <= 1e-3, f"seed 100 served twice: {http_same:.3e}")
        gen_counts = cuda_mod.launch_counts()
        for name in ("blur4", "upblur4"):
            check(gen_counts[name] > 0, f"kernel {name} was not launched by served generation")
        # generate images/s at bucket 4: 16 concurrent PNG requests, four full batches; the
        # first burst starts 16 server threads, the second finds the server warm
        burst16 = [_burst(base + "/v1/generate", [{"seed": s} for s in range(200 + k, 216 + k)]) for k in (0, 16)]
        gen_ips = [16 / b["wall_s"] for b in burst16]

        cuda_mod.reset_launches()
        buf = io.BytesIO()
        np.save(buf, np.asarray(solo["image"], np.float32))
        dec, ms = _http("POST", base + "/v1/attribute", {"image_npy_b64": base64.b64encode(buf.getvalue()).decode()})
        lat["attribute"].append(ms)
        check(len(dec["key_bits"]) == key_len and dec["loss"] is not None, f"attribute response {dec}")
        user_img = engine.generate(seed=7, user=reg.names[1])["image"]
        ident, ms = _http("POST", base + "/v1/identify", {"image": user_img.tolist()})
        lat["identify"].append(ms)
        check(ident["user"] in reg.names and len(ident["key_bits"]) == key_len, f"identify response {ident}")
        attr_counts = cuda_mod.launch_counts()
        check_all_launched(attr_counts, "served attribution")
        stats, ms = _http("GET", base + "/v1/stats")
        lat["stats"].append(ms)
        # the layers under a served generation, each alone: the engine (queue + batch,
        # no HTTP) solo and as a burst of 16, and the server's encodings of one image
        solo_engine = []
        for i in range(5):
            t1 = time.perf_counter()
            engine.generate(seed=300 + i)
            solo_engine.append((time.perf_counter() - t1) * 1e3)
        t1 = time.perf_counter()
        for f in [engine.generate(seed=400 + i, sync=False) for i in range(16)]:
            f.result(timeout=600)
        engine_ips = 16 / (time.perf_counter() - t1)
        img = np.asarray(solo["image"], np.float32)
        encode_ms = {}
        for name, fn in (("png_b64", lambda: port["server"]._png_b64(img)),
                         ("float_list_json", lambda: json.dumps({"image": img.tolist()}))):
            times = []
            for _ in range(3):
                t1 = time.perf_counter()
                fn()
                times.append((time.perf_counter() - t1) * 1e3)
            encode_ms[name] = statistics.median(times)
    finally:
        server.shutdown()
        server.server_close()
        engine.stop()
    # the engine's batch function alone (no HTTP, no queue), worker stopped: one seed at
    # bucket 1 and 4, and each bucket's time, host clock around a synchronize
    batch_ms = {}
    for kind, rows_of in (("generate", lambda b: [{"seed": 100 + i, "bits": None} for i in range(b)]),
                          ("attribute", lambda b: [{"image": np.asarray(solo["image"], np.float32)}] * b)):
        for b in (1, 4):
            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                out = engine.run_bucket(kind, b, rows_of(b))
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t1) * 1e3)
            batch_ms[f"{kind}:{b}"] = statistics.median(times)
            if kind == "generate":
                batch_ms[f"rows:{b}"] = out[0]
    same_seed = float(np.abs(batch_ms.pop("rows:4")[0] - batch_ms.pop("rows:1")[0]).max())
    check(same_seed <= 1e-3, f"seed 100 at bucket 1 vs bucket 4: {same_seed:.3e}")
    emit({"phase": "serve", "img_size": 256, "loss": "perceptual", "steps": 20, "restarts": 4, "buckets": [1, 4],
          "encoder_steps": 100, "registry_users": 16, "startup_seconds": startup,
          "latency_client": {"generate_solo_float_list_ms": solo_ms,
                             "generate_burst8_half_float_list": _pcts([r["ms"] for r in burst8["replies"]]),
                             "generate_burst16_png_first": _pcts([r["ms"] for r in burst16[0]["replies"]]),
                             "generate_burst16_png_second": _pcts([r["ms"] for r in burst16[1]["replies"]]),
                             **{k: _pcts(v) for k, v in lat.items()}},
          "generate_images_per_s_bucket4_png_first_second": gen_ips, "engine_batch_ms": batch_ms,
          "engine_generate_solo_ms": _pcts(solo_engine), "engine_generate_images_per_s_burst16": engine_ips,
          "server_encode_ms": encode_ms,
          "seed100_bucket1_vs_bucket4_max_abs": same_seed, "seed100_http_twice_max_abs": http_same,
          "generate_batches_for_8": batches, "identified": ident["user"], "planted": reg.names[1],
          "stats": stats, "launches_generate": gen_counts, "launches_attribute_identify": attr_counts, "gpu": gpu})

    # the tiny configuration: identify names the planted user
    C, pl = port["config"], port["pipeline"]
    mcfg = C.ModelConfig(**TINY)
    pipe = pl.build_pipeline(mcfg, C.FingerprintConfig(key_len=8, shift=56, n_pca_samples=2000),
                             generator=torch.Generator().manual_seed(TINY_SEED), want_lpips=False)
    treg = keys_mod.KeyRegistry.issue(8, key_len=8, min_distance=4, seed=0)
    tiny = serving.InferenceEngine(pipe, acfg=C.AttributionConfig(steps=300, n_starts=4, lr=0.2, loss="mse"),
                                   cfg=serving.ServeConfig(buckets=(1, 4)), seed=0, registry=treg).start()
    try:
        found = []
        for i, user in enumerate(("user_00003", "user_00006")):
            gen = tiny.generate(seed=77 + i, user=user)
            found.append(tiny.identify(gen["image"])["user"])
    finally:
        tiny.stop()
    emit({"phase": "serve_tiny", "planted": ["user_00003", "user_00006"], "identified": found})
    check(found == ["user_00003", "user_00006"], f"tiny served identify named {found}")
    return attr_counts


BIGGAN_FULL = ["--device", "cuda", "--random_init", "--model", "biggan", "--img_size", "256", "--key_len", "32",
               "--shift", "96"]
# the model configurations of phases 12-13 built through the library (the CLI flags above and FULL give the same)
SG2_MCFG = dict(img_size=256)
BIGGAN_MCFG = dict(model="biggan", img_size=256)
# a 32px BigGAN with attention before its last layer: recovers planted keys in 200 mse steps
TINY_BIGGAN = dict(z_dim=32, class_embed_dim=16, channel_width=8, num_classes=10, output_dim=32,
                   attention_layer_position=2, layers=((True, 16, 16), (True, 16, 8), (True, 8, 4)), n_stats=5)


def biggan_forward_macs(cfg) -> dict:
    """Multiply-adds of one image through ``models.biggan.generate``: gen_z, every
    block's four convs (3x3 ones at the upsampled size) and its batch-norm gains,
    the attention block (three 1x1 convs, two products, the output conv), the RGB
    conv.  Elementwise work is not counted."""
    ch, r = cfg.channel_width, 4
    total = cfg.cond_dim * 16 * 16 * ch + cfg.num_classes * cfg.class_embed_dim
    attention = 0
    for i, (up, in_m, out_m) in enumerate(cfg.layers):
        cin, cout = in_m * ch, out_m * ch
        if i == cfg.attention_layer_position:
            hw, c = r * r, cin
            attention = (2 * hw * c * (c // 8) + hw * c * (c // 2) + hw * (hw // 4) * (c // 8)
                         + hw * (hw // 4) * (c // 2) + hw * (c // 2) * c)
            total += attention
        mid, ro = cin // 4, (2 * r if up else r)
        total += cin * mid * r * r + 2 * mid * mid * 9 * ro * ro + mid * cout * ro * ro
        total += 2 * cfg.cond_dim * (cin + 3 * mid)
        r = ro
    total += cfg.layers[-1][2] * ch * 3 * 9 * r * r
    return {"gmac": total / 1e9, "attention_gmac": attention / 1e9}


def phase_biggan(torch, port, gpu):
    """(a) BigGAN-deep-256 through cli.generate and cli.attribute at full width,
    (b) the 16-chain solve step and batch-16 generation alone, (c) a tiny BigGAN
    recovers planted keys."""
    from PIL import Image
    import numpy as np

    C, pl, attr, bg, cuda_mod = port["config"], port["pipeline"], port["attribute"], port["biggan"], port["_cuda"]
    save = os.path.join(OUT, "biggan_generate")
    t0 = time.time()
    rc = port["cli_generate"].main(BIGGAN_FULL + ["--sample_size", "4", "--save_dir", save])
    gen_cli_seconds = time.time() - t0
    check(rc == 0, f"cli.generate --model biggan returned {rc}")
    pngs = [os.path.join(d, f) for d, _, fs in os.walk(save) for f in fs if f.endswith(".png")]
    marked = [p for p in pngs if os.sep + "watermarked" + os.sep in p]
    check(len(pngs) == 16 and len(marked) == 4, f"{len(pngs)} PNGs, {len(marked)} watermarked")
    hw = BIGGAN_MCFG["img_size"]
    for p in marked:
        check(np.asarray(Image.open(p)).shape == (hw, hw, 3), f"{p}: shape")

    steps, samples, starts = 20, 2, 4
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_mod.reset_launches()
    r = port["cli_attribute"].run(BIGGAN_FULL + ["--loss", "perceptual", "--sample_size", str(samples), "--n",
                                                 str(starts), "--steps", str(steps), "--save_dir",
                                                 os.path.join(OUT, "biggan_attribute")])
    counts = cuda_mod.launch_counts()
    peak_cli = torch.cuda.max_memory_allocated()
    check(os.path.exists(os.path.join(r.run_dir, "result.txt")), "cli.attribute --model biggan: no result.txt")
    check(len(r.bit_accs) == samples and all(v == v and abs(v) < float("inf") for v in r.losses),
          f"rows {r.bit_accs}, losses {r.losses}")
    for name in ("conv3x3_relu", "vgg_slice1_fwd", "vgg_slice1_bwd"):
        check(counts[name] > 0, f"kernel {name} was not launched by the BigGAN solve")
    for name in ("blur4", "upblur4", "upblur4_adj"):
        check(counts[name] == 0, f"kernel {name} launched {counts[name]} times by the BigGAN solve")

    # the 16-chain step alone (4 targets x 4 restarts), and generation at batch 16
    mcfg = C.ModelConfig(**BIGGAN_MCFG)
    pipe = pl.build_pipeline(mcfg, C.FingerprintConfig(key_len=32, shift=mcfg.style_space_dim - 32),
                             generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        targets = torch.clamp(pl.generate_fingerprinted(pipe, 4, g)[0], -1.0, 1.0)
        feats = [f[:, None] for f in port["lpips"].extract_features(pipe.lpips_params, targets)]
    acfg = C.AttributionConfig(steps=20, n_starts=4, loss="perceptual")
    step, _ = attr.make_attribution_step(pipe.gen_params, pipe.lpips_params, pipe.basis, pipe.noise, mcfg, acfg,
                                         feats, None, **pl.solver_kwargs(pipe))
    d_rest = pipe.basis.sigma_rest.shape[0]
    alpha0 = (torch.rand((4, 4, d_rest), generator=g) * 2 - 1).to(pipe.device) * pipe.basis.sigma_rest
    state = attr.init_state(alpha0, torch.zeros((4, 4, 32), device=pipe.device))
    holder = {"state": state}

    def one_step():
        holder["state"], _ = step(holder["state"])

    one_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = median_ms(torch, one_step, reps=5, warmup=1)
    peak16 = torch.cuda.max_memory_allocated()
    by_kernel = device_kernel_ms(torch, one_step, calls=2)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:15]
    # the same step in bf16: the targets' features in bf16, the generator (its z widened at
    # the class embedding, as in the reference) and the estimate's LPIPS in float32
    feats16, _ = attr._targets_for_loss(pipe.lpips_params, targets, acfg, "bfloat16")
    step16, _ = attr.make_attribution_step(pipe.gen_params, pipe.lpips_params, pipe.basis, pipe.noise, mcfg, acfg,
                                           feats16, None, dtype="bfloat16", **pl.solver_kwargs(pipe))
    holder16 = {"state": attr.init_state(alpha0, torch.zeros((4, 4, 32), device=pipe.device))}

    def one_step16():
        holder16["state"], per = step16(holder16["state"])
        return per

    one_step16()
    torch.cuda.synchronize()
    cuda_mod.reset_launches()
    per16 = one_step16()
    torch.cuda.synchronize()
    bf16_launches = cuda_mod.launch_counts()
    check(bool(torch.isfinite(per16).all()), "BigGAN bf16 step: non-finite loss")
    bf16_step_ms = median_ms(torch, one_step16, reps=5, warmup=1)
    cuda_mod.reset_launches()
    with torch.no_grad():
        gen_ms = median_ms(torch, lambda: pl.generate_fingerprinted(pipe, 16, g), reps=5, warmup=1)
        gen_by_kernel = device_kernel_ms(torch, lambda: pl.generate_fingerprinted(pipe, 16, g), calls=2)
    check(all(v == 0 for v in cuda_mod.launch_counts().values()), "BigGAN generation launched a kernel")
    macs = biggan_forward_macs(pipe.biggan_cfg)
    emit({"phase": "biggan", "config": "BigGAN-deep-256 (random init)", "img_size": mcfg.img_size, "key_len": 32,
          "loss": "perceptual", "forward_gmac_per_image": macs["gmac"], "attention_gmac_per_image": macs["attention_gmac"],
          "cli_generate_seconds_4_images": gen_cli_seconds,
          "generate_batch16_ms": gen_ms, "generate_images_per_s_batch16": 16e3 / gen_ms,
          "generate_batch16_device_busy_ms": sum(gen_by_kernel.values()),
          "generate_batch16_device_ms_top8": [[k[:90], v] for k, v in
                                               sorted(gen_by_kernel.items(), key=lambda kv: -kv[1])[:8]],
          "cli_attribute": {"samples": samples, "restarts": starts, "steps": steps, "solve_seconds": r.solve_seconds,
                            "chain_steps_per_s": r.chain_steps / r.solve_seconds, "losses": r.losses,
                            "bit_acc": r.bit_accs, "max_memory_allocated_bytes": peak_cli},
          "step16_ms": step_ms, "step16_chain_steps_per_s": 16e3 / step_ms,
          "step16_bf16_ms": bf16_step_ms, "step16_bf16_launches_per_step": bf16_launches,
          "step16_max_memory_allocated_bytes": peak16, "step16_device_busy_ms": sum(by_kernel.values()),
          "step16_device_ms_top15": [[k[:90], v] for k, v in top], "launches": counts, "gpu": gpu})

    # the tiny BigGAN: planted keys come back
    tcfg = bg.BigGANConfig(**TINY_BIGGAN)
    tm = C.ModelConfig(model="biggan", img_size=32, biggan_label="3")
    tpipe = pl.build_pipeline(tm, C.FingerprintConfig(key_len=8, shift=24, sigma=1.0, n_pca_samples=2000),
                              generator=torch.Generator().manual_seed(1), want_lpips=False, biggan_cfg=tcfg)
    imgs, _, _, bits, _ = pl.generate_fingerprinted(tpipe, 3, torch.Generator().manual_seed(2))
    t0 = time.time()
    res = attr.attribute(tpipe.gen_params, None, tpipe.basis, tpipe.noise, imgs, mcfg=tm,
                         acfg=C.AttributionConfig(steps=200, n_starts=4, lr=0.2, loss="mse"),
                         generator=torch.Generator().manual_seed(3), **pl.solver_kwargs(tpipe))
    torch.cuda.synchronize()
    accs = [float(a) for a in attr.evaluate_attribution(res, bits)["bit_acc"].cpu()]
    emit({"phase": "biggan_tiny", "bit_acc": accs, "exact": sum(a >= 1.0 for a in accs),
          "loss": [float(v) for v in res.loss.cpu()], "seconds": time.time() - t0})
    check(sum(accs) / 3 > 0.85, f"tiny BigGAN: mean bit accuracy {sum(accs) / 3:.3f} <= 0.85")
    check(sum(a >= 1.0 for a in accs) >= 2, f"tiny BigGAN: fewer than 2 of 3 keys exact: {accs}")
    return counts


def phase_model_attribution(torch, port, gpu):
    """(a) cli.model_attribute over two full-width StyleGAN2s, (b) attribute_model
    over a mixed {StyleGAN2, BigGAN} registry, (c) the tiny open-set check."""
    import numpy as np

    C, pl, ma, cuda_mod = port["config"], port["pipeline"], port["model_attribution"], port["_cuda"]
    fold_in = port["lhs"].fold_in
    out = os.path.join(OUT, "model_attribution.json")
    torch.cuda.synchronize()
    cuda_mod.reset_launches()
    t0 = time.time()
    rec = port["cli_model_attribute"].run(FULL + ["--sample_size", "2", "--calibrate", "1", "--n", "4", "--steps", "20",
                                                  "--out", out])
    cli_seconds = time.time() - t0
    counts = cuda_mod.launch_counts()
    check_all_launched(counts, "cli.model_attribute")
    with open(out) as fh:
        check(json.load(fh) == rec, "the --out record differs from the run's")
    lm = np.asarray(rec["loss_matrix"])
    check(lm.shape == (2, 2) and bool(np.isfinite(lm).all()), f"loss matrix {rec['loss_matrix']}")
    check(rec["open_set_threshold"] is not None and len(rec["decisions"]) == 2, "threshold or decisions missing")

    # a mixed registry: one key length, each family its own latent
    acfg = C.AttributionConfig(steps=20, n_starts=4, loss="perceptual")
    sm, bm = C.ModelConfig(**SG2_MCFG), C.ModelConfig(**BIGGAN_MCFG)
    sp = pl.build_pipeline(sm, C.FingerprintConfig(key_len=32, shift=sm.style_space_dim - 32), generator=fold_in(0, 0))
    bp = pl.build_pipeline(bm, C.FingerprintConfig(key_len=32, shift=bm.style_space_dim - 32),
                           generator=fold_in(0, 1), lpips_params=sp.lpips_params)
    g = torch.Generator().manual_seed(5)
    targets = torch.cat([torch.clamp(pl.generate_fingerprinted(p, 1, g)[0], -1.0, 1.0) for p in (sp, bp)])
    torch.cuda.synchronize()
    t0 = time.time()
    mixed = ma.attribute_model({"sg2": sp, "biggan": bp}, targets, g, acfg)
    torch.cuda.synchronize()
    mixed_seconds = time.time() - t0
    check(mixed.losses.shape == (2, 2) and bool(np.isfinite(mixed.losses).all()), f"mixed losses {mixed.losses}")
    emit({"phase": "model_attribution", "img_size": sm.img_size, "loss": "perceptual", "restarts": 4, "steps": 20,
          "cli": {"models": rec["models"], "loss_matrix": rec["loss_matrix"], "decisions": rec["decisions"],
                  "open_set_threshold": rec["open_set_threshold"], "self_test_accuracy": rec["self_test_accuracy"],
                  "wall_seconds": cli_seconds},
          "mixed_registry": {"models": mixed.model_names, "key_len": 32, "loss_matrix": mixed.losses.tolist(),
                             "best_model": mixed.best_model.tolist(), "margin": mixed.margin.tolist(),
                             "seconds": mixed_seconds},
          "launches": counts, "gpu": gpu})

    # tiny: targets named for their model, a held-out model's rejected at the calibrated threshold
    tm = C.ModelConfig(**TINY)
    # the reference package's own test of this check: 450 mse steps, 4 restarts
    tfp = C.FingerprintConfig(key_len=8, shift=56, sigma=1.0, n_pca_samples=2000)
    tacfg = C.AttributionConfig(steps=450, n_starts=4, lr=0.2, loss="mse")
    pipes = {n: pl.build_pipeline(tm, tfp, generator=torch.Generator().manual_seed(s), want_lpips=False)
             for n, s in (("a", 0), ("b", 100), ("held", 777))}
    registry = {n: pipes[n] for n in ("a", "b")}
    tau = port["cli_model_attribute"].calibrate(registry, C.Config(model=tm, fingerprint=tfp, attribution=tacfg), 2,
                                                torch.Generator().manual_seed(6), clip=False)
    targets = torch.cat([pl.generate_fingerprinted(pipes[n], 2, torch.Generator().manual_seed(10 + i))[0]
                         for i, n in enumerate(pipes)])
    res = ma.attribute_model(registry, targets, torch.Generator().manual_seed(7), tacfg, open_set_threshold=tau)
    chosen = [res.chosen(s) for s in range(6)]
    emit({"phase": "model_attribution_tiny", "threshold": tau, "losses": res.losses.tolist(), "chosen": chosen,
          "coherence": res.coherence.tolist()})
    check(chosen == ["a", "a", "b", "b", None, None], f"tiny registry chose {chosen} (threshold {tau:.3e})")
    return counts


def phase_studies_bf16(torch, port, gpu):
    """``identification_point`` and ``model_attribution_point`` at their
    defaults (bfloat16, as in the reference) on the tiny configuration, with
    few steps: records complete, the solves' bf16 FIR kernels launched (mse
    solves run no LPIPS kernel), float32 kernels only in the target renders."""
    import importlib

    C, pl, cuda_mod = port["config"], port["pipeline"], port["_cuda"]
    ident = importlib.import_module(f"{PORT}.eval.identification")
    study = importlib.import_module(f"{PORT}.eval.model_attribution_study")
    fp = C.FingerprintConfig(key_len=8, shift=56, n_pca_samples=2000)
    pipes = [pl.build_pipeline(C.ModelConfig(**TINY), fp, generator=torch.Generator().manual_seed(s), want_lpips=False)
             for s in (0, 100, 777)]
    cuda_mod.reset_launches()
    t0 = time.time()
    with renders_counted(port) as ident_renders:
        rec = ident.identification_point(pipes[0], key_len=8, sigma=1.0, shift=56, min_distance=3,
                                         registry_sizes=(4, 8), samples=4, steps=30, n_starts=4, clip_targets=False)
    torch.cuda.synchronize()
    ident_seconds, ident_counts = time.time() - t0, cuda_mod.launch_counts()
    cuda_mod.reset_launches()
    t0 = time.time()
    with renders_counted(port) as study_renders:
        mrec = study.model_attribution_point({"a": pipes[0], "b": pipes[1]}, {"held": pipes[2]}, key_len=8,
                                             sigma=1.0, samples_per_model=2, steps=30, n_starts=4, chunk_samples=6,
                                             clip_targets=False)
    torch.cuda.synchronize()
    study_seconds, study_counts = time.time() - t0, cuda_mod.launch_counts()
    need = [name + BF16 for name in ("blur4", "upblur4", "upblur4_adj")]
    check_bf16_solve(ident_counts, ident_renders, "identification_point", need)
    check_bf16_solve(study_counts, study_renders, "model_attribution_point", need)
    check([r["registry_size"] for r in rec["by_registry_size"]] == [4, 8], "identification record")
    check(mrec["n_eval_in_dist"] == 2, "model attribution record")
    emit({"phase": "studies_bf16", "dtype": "bfloat16", "steps": 30,
          "identification": {"mean_bit_acc": rec["mean_bit_acc"], "by_registry_size": rec["by_registry_size"],
                             "seconds": ident_seconds, "launches": of_dtype(ident_counts, "bfloat16")},
          "model_attribution": {"decision_acc": mrec["decision_acc"], "open_set_threshold": mrec["open_set_threshold"],
                                "open_set_auc": mrec["open_set_auc"], "seconds": study_seconds,
                                "launches": of_dtype(study_counts, "bfloat16")},
          "gpu": gpu})
    return study_counts


def second_derivative(torch, fn, x, c):
    """d/dx sum(g^2) with g = d/dx sum(tanh(fn(x)) * c): a gradient of a
    gradient through ``fn``, as the R1 penalty takes one through D's blurs."""
    x = x.clone().requires_grad_(True)
    (g,) = torch.autograd.grad((torch.tanh(fn(x)) * c).sum(), x, create_graph=True)
    return torch.autograd.grad(g.square().sum(), x)[0]


def phase_second_derivative(torch, mods, disc_shapes):
    """The second derivative through the FIR kernels' autograd Functions on the
    card (forward, adjoint and the adjoint's backward all kernels) against the
    plain versions differentiated twice on the CPU, at the discriminator's
    widths (batch 2; the widest and the narrowest block, both pads) and at the
    largest ToRGB skip shape; within 1e-4 * max(1, max|CPU|)."""
    up_cuda, upf = mods[0], mods[3]
    k0 = upf.split_symmetric_4tap(upf.make_kernel((1, 3, 3, 1)))
    k1 = upf.split_symmetric_4tap(upf.make_kernel((1, 3, 3, 1)) * 4.0)
    g = torch.Generator().manual_seed(3)
    cases = []
    for c, r in (disc_shapes[0], disc_shapes[-1]):
        for p in (2, 1):
            o = r + 2 * p - 3
            cases.append((f"blur4 D_C{c}_R{r}_p{p}{p}", lambda v, p=p: up_cuda.blur4(v, k0, k0, (p, p), (p, p)),
                          torch.randn((2, r, r, c), generator=g), torch.randn((2, o, o, c), generator=g)))
    rgb = torch.randn((2, 256, 256, 3), generator=g)
    cases.append(("upblur4 C3_H128", lambda v: up_cuda.upblur4_add(rgb.to(v.device, v.dtype), v, k1),
                  torch.randn((2, 128, 128, 3), generator=g), torch.randn((2, 256, 256, 3), generator=g)))
    for label, fn, x, c in cases:
        want = second_derivative(torch, fn, x, c)
        got = second_derivative(torch, fn, x.cuda(), c.cuda()).cpu()
        err, scale = (got - want).abs().max().item(), max(1.0, want.abs().max().item())
        check(bool(torch.isfinite(got).all()), f"{label}: non-finite second derivative")
        check(err <= TOL * scale, f"{label}: second derivative error {err:.3e} > {TOL} * {scale:.3e}")
        emit({"phase": "second_derivative", "case": label, "batch": 2, "max_abs_err": err, "scale": scale})
    # once in bf16: the widest discriminator blur, the ToRGB skip and the whole skip chain
    # (4^2 -> 32^2: one launch each way, the cascade's backward the chain again), the bf16
    # kernels against the plain bf16 versions on the CPU (each output rounded once on both sides)
    ts = [torch.randn((2, 4 << k, 4 << k, 3), generator=g) for k in range(4)]

    def chain(v):  # differentiated at t_0: through the cascade, and the chain again
        return up_cuda.upblur4_chain([v] + [t.to(v.device, v.dtype) for t in ts[1:]], k1)

    for label, fn, x, c in (cases[0], cases[-1], ("upblur4 chain C3_H4-H32", chain, ts[0],
                                                  torch.randn((2, 32, 32, 3), generator=g))):
        xb, cb = x.bfloat16(), c.bfloat16()
        want = second_derivative(torch, fn, xb, cb).float()
        got = second_derivative(torch, fn, xb.cuda(), cb.cuda()).cpu()
        err, scale = (got.float() - want).abs().max().item(), want.abs().max().item()
        check(got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all()), f"{label} bf16: second derivative")
        check(err < BF16_TOL * scale, f"{label} bf16: second derivative error {err:.3e} >= {BF16_TOL} * {scale:.3e}")
        emit({"phase": "second_derivative", "case": label + BF16, "batch": 2, "max_abs_err": err, "scale": scale})


def phase_train(torch, port, gpu):
    """StyleGAN2-256 at full width (style_dim 512, n_mlp 8, channel_max 512,
    multiplier 2) with its discriminator, random weights from a seed, batch 16,
    lazy R1 every 4 steps: 6 warm-up steps (their launches per step, with and
    without R1, against ``ops/roofline.py::train_launches``), then 8 timed steps
    (CUDA events; 2 with R1), peak memory, finite losses, and one
    ``torch.profiler`` pass over 4 steps (1 with R1)."""
    C, gan, cuda_mod, roof = port["config"], port["gan"], port["_cuda"], port["roof"]
    mcfg = C.ModelConfig(img_size=256)
    tcfg = gan.TrainConfig(d_reg_every=4)
    check(tcfg.batch == 16, f"TrainConfig's default batch is {tcfg.batch}")
    seed = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = gan.init_train_state(mcfg, tcfg, torch.Generator().manual_seed(seed), "cuda")
    gan.run_steps(state, seed, 4, mcfg, tcfg)  # steps 0-3
    per_step = {}
    for label in ("r1", "no_r1"):  # steps 4 and 5
        cuda_mod.reset_launches()
        gan.run_steps(state, seed, 1, mcfg, tcfg)
        per_step[label] = cuda_mod.launch_counts()
        want = roof.train_launches(256, label == "r1")
        check(of_dtype(per_step[label]) == want and not any(of_dtype(per_step[label], "bfloat16").values()),
              f"training step ({label}) launched {per_step[label]}, expected {want}")
    cuda_mod.reset_launches()
    ms = {"r1": [], "no_r1": []}
    rows = []
    for _ in range(8):  # steps 6-13, R1 at 8 and 12
        label = "r1" if state.step % tcfg.d_reg_every == 0 else "no_r1"
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        m = gan.run_steps(state, seed, 1, mcfg, tcfg)
        b.record()
        b.synchronize()
        ms[label].append(a.elapsed_time(b))
        rows.append({k: float(v[0]) for k, v in m.items()})
    counts = cuda_mod.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = {k: 2 * v + 6 * roof.train_launches(256, False)[k] for k, v in roof.train_launches(256, True).items()}
    check(of_dtype(counts) == want and not any(of_dtype(counts, "bfloat16").values()),
          f"8 timed training steps launched {counts}, expected {want}")
    check(all(v == v and abs(v) < float("inf") for r in rows for v in r.values()), f"non-finite losses {rows}")
    check([r["r1"] > 0 for r in rows] == [False, False, True, False, False, False, True, False], "R1 schedule")
    prof = device_kernel_ms(torch, lambda: gan.run_steps(state, seed, 4, mcfg, tcfg), calls=1)
    busy = sum(prof.values()) / 4
    top = sorted(prof.items(), key=lambda kv: -kv[1])[:15]
    groups = {}  # device ms a step: the FIR kernels by name, then cuDNN / cuBLAS, PyTorch's own, the rest
    for k, v in prof.items():
        g = next((n for n in ("upblur4_adj", "upblur4", "blur4") if n in k), None)
        if g is None:
            g = ("cudnn_cublas" if any(w in k for w in ("cudnn", "xmma", "convolve", "grad_engine", "gemm")) else
                 "pytorch_elementwise_reduce" if "at::native" in k else "other")
        groups[g] = groups.get(g, 0.0) + v / 4
    emit({"phase": "train", "img_size": 256, "style_dim": 512, "n_mlp": 8, "channel_max": 512, "batch": 16,
          "d_reg_every": 4, "ms_step_r1": ms["r1"], "ms_step_no_r1": ms["no_r1"],
          "median_ms_step_r1": statistics.median(ms["r1"]), "median_ms_step_no_r1": statistics.median(ms["no_r1"]),
          "images_per_s_no_r1": 16e3 / statistics.median(ms["no_r1"]), "max_memory_allocated_bytes": peak,
          "losses": rows, "launches_per_step": per_step, "launches_timed_steps": counts,
          "profile_steps": 4, "profile_r1_steps": 1, "device_busy_ms_per_step": busy,
          "device_ms_per_step_by_group": groups,
          "top_device_ms_per_4_steps": {k: v for k, v in top}, "gpu": gpu})
    return counts


def phase_train_tiny(torch, port, gpu):
    """The self-train loop through ``cli.train`` at the CLI's defaults (64px,
    channel_max 128, batch 16), each run its own process under
    ``cudnn.deterministic``: 40 steps with a snapshot, the same run resumed to
    80, and 80 uninterrupted; the two exports (EMA generator and discriminator)
    must be equal and the metrics one row a step.  Then ``cli.attribute --ckpt``
    on the trained generator (2 samples x 4 restarts, 100 mse steps): its bit
    accuracy is printed, not held to a figure."""
    import numpy as np

    # the snapshot and exports (~0.2 GB) go to a git-ignored work directory, not under OUT
    work = os.path.join(ROOT, "_chip_work", "train_tiny")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    snap, metrics = os.path.join(work, "snap.npz"), os.path.join(work, "metrics.jsonl")
    part, whole = os.path.join(work, "resumed.npz"), os.path.join(work, "whole.npz")
    code = ("import sys, torch\n"
            "torch.backends.cudnn.deterministic = True\n"
            "torch.backends.cudnn.benchmark = False\n"
            f"from {PORT}.cli.train import main\n"
            "sys.exit(main(sys.argv[1:]))\n")
    base = ["--device", "cuda", "--seed", "0", "--chunk", "20"]
    seconds = []
    for args in (["--steps", "40", "--snapshot", snap, "--metrics_out", metrics, "--out", part],
                 ["--steps", "80", "--snapshot", snap, "--resume", "--metrics_out", metrics, "--out", part],
                 ["--steps", "80", "--out", whole]):
        t0 = time.time()
        r = run_child([sys.executable, "-c", code, *base, *args], 600, cwd=ROOT)
        seconds.append(time.time() - t0)
        print(r.stdout, end="", flush=True)
        check(r.returncode == 0, f"cli.train {args} returned {r.returncode}: {r.stderr[-2000:]}")
    for suffix in ("", ".disc.npz"):
        with np.load(part + suffix) as a, np.load(whole + suffix) as b:
            check(sorted(a.files) == sorted(b.files), f"export{suffix}: tensor names differ")
            diff = [k for k in a.files if not np.array_equal(a[k], b[k])]
            check(not diff, f"resumed export{suffix} differs from the uninterrupted run in {diff[:5]}")
    rows = [json.loads(line) for line in open(metrics)]
    check([r["step"] for r in rows] == list(range(1, 81)), "metrics rows are not one a step across --resume")
    check(all(abs(r[k]) < float("inf") for r in rows for k in ("d_loss", "g_loss", "r1")), "non-finite metrics")
    t0 = time.time()
    res = port["cli_attribute"].run(["--device", "cuda", "--ckpt", whole, "--img_size", "64", "--channel_max", "128",
                                     "--loss", "mse", "--sample_size", "2", "--n", "4", "--steps", "100",
                                     "--save_dir", os.path.join(work, "attribute")])
    check(all(v == v and abs(v) < float("inf") for v in res.losses), f"non-finite losses {res.losses}")
    shutil.rmtree(work, ignore_errors=True)
    emit({"phase": "train_tiny", "img_size": 64, "channel_max": 128, "batch": 16, "steps": 80,
          "resume_equal": True, "process_seconds": seconds, "d_loss_last": rows[-1]["d_loss"],
          "g_loss_last": rows[-1]["g_loss"], "attribute_bit_acc": res.bit_accs, "attribute_losses": res.losses,
          "attribute_seconds": time.time() - t0, "gpu": gpu})


# Phase 16 runs ``cli.study`` in processes of its own; this runner wraps it so that the
# process reports its launch counts: by kernel over the whole run, and those made inside
# the windows where float32 launches belong (the target renders ``pipeline.synthesize``,
# the 2AFC calibration, the generator's training, ``capacity``'s visibility LPIPS) and
# inside the discriminator's feature pass, with the shapes of every bf16 ``blur4``
# launch; and the host seconds and calls of the Frechet distances and of Inception's
# features (with their image count).
STUDY_RUNNER = r"""
import json, sys, time
root, counts_path, train_steps, argv = sys.argv[1], sys.argv[2], int(sys.argv[3]), sys.argv[4:]
sys.path.insert(0, root)
PORT = "attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch"
import importlib
import torch
cuda_mod = importlib.import_module(PORT + ".ops._cuda")
up = importlib.import_module(PORT + ".ops.upfirdn2d_cuda")
pl = importlib.import_module(PORT + ".fingerprint.pipeline")
cal = importlib.import_module(PORT + ".losses.calibrate")
dp = importlib.import_module(PORT + ".losses.disc_percept")
est = importlib.import_module(PORT + ".eval.study")
fid = importlib.import_module(PORT + ".eval.fid")
lp = importlib.import_module(PORT + ".losses.lpips")
cli = importlib.import_module(PORT + ".cli.study")
windows = {w: {n: 0 for n in cuda_mod.KERNELS}
           for w in ("renders", "calibration", "training", "disc_features", "visibility", "frechet", "inception")}
seconds = {w: 0.0 for w in windows}
calls = {w: 0 for w in windows}
images = {"inception": 0}

def counted(window, fn):
    def wrapped(*args, **kwargs):
        before, t0 = cuda_mod.launch_counts(), time.time()
        try:
            return fn(*args, **kwargs)
        finally:
            seconds[window] += time.time() - t0
            calls[window] += 1
            for name, n in cuda_mod.launch_counts().items():
                windows[window][name] += n - before[name]
    return wrapped

compute_features = fid.compute_features

def inception_counted(params, imgs, batch=16):
    images["inception"] += imgs.shape[0]
    return compute_features(params, imgs, batch)  # a host array: the card has finished

pl.synthesize = counted("renders", pl.synthesize)
cal.calibrate_lin_heads = counted("calibration", cal.calibrate_lin_heads)
cal.rank_accuracy = counted("calibration", cal.rank_accuracy)
ensure_trained = est.ensure_trained

def ensure_trained_cut(**kw):
    # the recipe trained train_steps deep (its widths, batch and seed as the study gives them)
    return ensure_trained(**{**kw, "train_steps": train_steps})

est.ensure_trained = counted("training", ensure_trained_cut)
dp.disc_features = counted("disc_features", dp.disc_features)
lp.lpips = counted("visibility", lp.lpips)
fid.frechet_distance = counted("frechet", fid.frechet_distance)
fid.compute_features = counted("inception", inception_counted)
shapes = set()
launch = up.blur4_launch

def blur4_launch(x, fy, fx, pad_y, pad_x):
    if x.dtype == torch.bfloat16:
        shapes.add((tuple(x.shape), tuple(pad_y)))
    return launch(x, fy, fx, pad_y, pad_x)

up.blur4_launch = blur4_launch
rc = cli.main(argv)
cuda = torch.cuda.is_available()
if cuda:
    torch.cuda.synchronize()
with open(counts_path, "w") as f:
    json.dump({"launches": cuda_mod.launch_counts(), "windows": windows, "window_seconds": seconds,
               "window_calls": calls, "inception_images": images["inception"],
               "blur4_bf16_shapes": sorted(shapes), "peak_bytes": torch.cuda.max_memory_allocated() if cuda else 0},
              f)
sys.exit(rc)
"""

STUDY_KEYS = {"img_size", "channel_max", "ckpt", "key_len", "sigma", "shift", "attack", "loss", "samples", "steps",
              "n_starts", "chain_steps_per_sample", "mean_bit_acc", "bit_acc_ci95", "bit_acc_min", "exact_match",
              "exact_match_k", "exact_match_ci95", "mean_final_loss", "per_bit_acc", "band_sigma",
              "band_sigma_median", "content_sigma_median", "spectrum_decile_sigmas", "tag", "train_steps",
              "bit_sigma_spearman", "wall_s"}
STUDY_BUDGET = ["--samples", "2", "--steps", "40", "--n", "4"]
# the study's 64px recipe is trained 3000 steps; here 600 (its host-bound loop was a quarter of the run)
STUDY_TRAIN_STEPS = 600


def study_run(work: str, argv, timeout: int, module: str = "study"):
    """One ``cli.study`` (through STUDY_RUNNER) or ``cli.report`` process in ``work``:
    (seconds, stdout, the runner's counts or None)."""
    counts_path = os.path.join(work, "counts.json")
    if os.path.exists(counts_path):
        os.remove(counts_path)
    if module == "study":
        cmd = [sys.executable, "-c", STUDY_RUNNER, ROOT, counts_path, str(STUDY_TRAIN_STEPS), *argv]
    else:
        cmd = [sys.executable, "-m", f"{PORT}.cli.{module}", *argv]
    env = dict(os.environ, PYTHONPATH=ROOT)
    t0 = time.time()
    r = run_child(cmd, timeout, cwd=work, env=env)
    seconds = time.time() - t0
    print(r.stdout, end="", flush=True)
    check(r.returncode == 0, f"cli.{module} {argv} returned {r.returncode}: {r.stderr[-3000:]}")
    counts = None
    if module == "study":
        with open(counts_path) as f:
            counts = json.load(f)
    return seconds, r.stdout, counts


def study_records(work: str, name: str, tags):
    """The records of ``tags`` in ``work``'s ``result/study_<name>_torch.json.jsonl``,
    each complete (identification: its own keys) with a finite final loss."""
    with open(os.path.join(work, "result", f"study_{name}_torch.json.jsonl")) as f:
        recs = {r["tag"]: r for r in map(json.loads, f)}
    check(sorted(recs) == sorted(tags), f"study_{name}: records {sorted(recs)}, expected {sorted(tags)}")
    for tag, r in recs.items():
        if name == "identification":
            check({"measured_p_bit", "by_registry_size", "mean_bit_acc"} <= set(r), f"{tag}: record {sorted(r)}")
            check([row["registry_size"] for row in r["by_registry_size"]] == [10, 100, 1000], f"{tag}: registry")
        else:
            check(set(r) == STUDY_KEYS, f"{tag}: keys {sorted(set(r) ^ STUDY_KEYS)} differ")
            check(r["mean_final_loss"] == r["mean_final_loss"] and abs(r["mean_final_loss"]) < float("inf"),
                  f"{tag}: final loss {r['mean_final_loss']}")
            check(len(r["per_bit_acc"]) == r["key_len"] == 32, f"{tag}: per-bit accuracy")
    return recs


def point_lines(stdout: str) -> dict:
    """{tag: {"wall_s", "peak_gb"}} from ``cli.study``'s per-point lines."""
    import re

    out = {}
    for m in re.finditer(r"\[study\] (\S+): .*?, ([0-9.]+)s, peak ([0-9.]+) GB", stdout):
        out[m.group(1)] = {"wall_s": float(m.group(2)), "peak_gb": float(m.group(3))}
    return out


def check_study_launches(counts, path: str, need_bf16, float32_windows=("renders", "calibration", "training")) -> None:
    """A study run's launches: float32 kernels only inside ``float32_windows``
    (its renders, calibration and training by default; these launch no bf16
    kernel); the bf16 kernels in ``need_bf16`` launched."""
    w = counts["windows"]
    inside = {n: sum(w[k][n] for k in float32_windows) for n in counts["launches"]}
    check(of_dtype(counts["launches"]) == of_dtype(inside) and not any(of_dtype(inside, "bfloat16").values()),
          f"{path}: float32 launches {of_dtype(counts['launches'])} outside {float32_windows}: {inside}")
    for name in need_bf16:
        check(counts["launches"][name] > 0, f"kernel {name} was not launched by {path}")


def phase_studies(torch, port, gpu, device="cuda", budget=STUDY_BUDGET):
    """Phase 16: the port's ``cli.study`` on the card, one process a run, in a
    git-ignored work directory (so the default ``result/study_<name>_torch.json``
    names are used there), at the study's own width: StyleGAN2 at 64 px,
    channel_max 128, style_dim 512, n_mlp 8, trained at batch 16 by
    ``ensure_trained`` (with its discriminator) STUDY_TRAIN_STEPS deep (the
    recipe's 3000 cut), PCA over 10000 samples.

    1. ``robustness --only 64px_kl32_s6_Jpeg``: trains the recipe once into the
       phase's ``--cache_dir``; the training's wall time, the pipeline's (PCA
       included), the point's time and its peak memory;
    2. ``perceptual --only _Jpeg``: the five backbones (mse, disc, vgg_rand,
       disc_cal, vgg_cal; the ``_cal`` ones print their rank accuracy before and
       after calibration): every ``_bf16`` kernel launched, ``blur4_bf16`` inside
       the discriminator's feature pass, float32 kernels only in the target
       renders and the calibration;
    3. ``identification --only ident_64px_kl32_s6_None``;
    4. step 2 again: every point ``cached``, nothing trained, no launch;
    5. ``cli.report robustness perceptual identification``: the three tables.

    Every run exits 0 with complete records and finite losses.  Cut from the
    study's defaults: ``--samples 2`` (20), ``--steps 40`` (2000), ``--n 4`` (20),
    and only the points named above run."""
    work = os.path.join(ROOT, "_chip_work", "studies")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    base = ["--device", device, "--cache_dir", os.path.join(work, "ckpts"), *budget]
    bf16_names = [n for n in port["_cuda"].KERNELS if n.endswith(BF16)]
    runs, line = {}, {"phase": "studies", "img_size": 64, "channel_max": 128, "style_dim": 512, "n_mlp": 8,
                      "train_steps": STUDY_TRAIN_STEPS, "recipe_train_steps": 3000, "train_batch": 16, "n_pca_samples": 10000, "samples": 2, "steps": 40,
                      "restarts": 4, "dtype": "bfloat16"}

    seconds, out, counts = study_run(work, ["robustness", "--only", "64px_kl32_s6_Jpeg", *base], 900)
    study_records(work, "robustness", ["64px_kl32_s6_Jpeg"])
    check(counts["launches"]["blur4"] > 0 and counts["windows"]["training"]["blur4"] > 0, "robustness: no training")
    check_study_launches(counts, "study robustness", [n + BF16 for n in ("blur4", "upblur4", "upblur4_adj")])
    runs["robustness"] = counts
    import re

    line["train_seconds"] = counts["window_seconds"]["training"]
    line["pipeline_seconds"] = float(re.search(r"pipeline 64px cm128 built in ([0-9.]+)s", out).group(1))
    points = point_lines(out)
    line["robustness"] = {"process_seconds": seconds, "points": points, "peak_bytes": counts["peak_bytes"],
                          # a point's wall time counts the training it waited for, as in the reference
                          "point_seconds_after_training": points["64px_kl32_s6_Jpeg"]["wall_s"] - line["train_seconds"]}

    perceptual = ["perceptual", "--only", "_Jpeg", *base]
    tags = [f"64px_kl32_s6_{b}_Jpeg" for b in ("mse", "disc", "vgg_rand", "disc_cal", "vgg_cal")]
    seconds, out, counts = study_run(work, perceptual, 600)
    recs = study_records(work, "perceptual", tags)
    check_study_launches(counts, "study perceptual", bf16_names)
    check(counts["windows"]["training"] == {n: 0 for n in counts["launches"]}, "perceptual: trained again")
    disc_blur = counts["windows"]["disc_features"]["blur4" + BF16]
    check(disc_blur > 0, "perceptual: blur4_bf16 never launched inside the discriminator's feature pass")
    cal_lines = re.findall(r"2AFC calibration: rank acc ([0-9.]+) -> ([0-9.]+) \(([0-9.]+)s\)", out)
    check(len(cal_lines) == 2, f"perceptual: {len(cal_lines)} calibration lines")
    check(of_dtype(counts["windows"]["calibration"])["conv3x3_relu"] > 0
          and of_dtype(counts["windows"]["calibration"])["blur4"] > 0, "perceptual: calibration's float32 features")
    runs["perceptual"] = counts
    line["perceptual"] = {
        "process_seconds": seconds, "points": point_lines(out), "peak_bytes": counts["peak_bytes"],
        "mean_bit_acc": {t: recs[t]["mean_bit_acc"] for t in tags},
        "mean_final_loss": {t: recs[t]["mean_final_loss"] for t in tags},
        "calibration": [{"rank_acc_before": float(a), "rank_acc_after": float(b), "seconds": float(c)}
                        for a, b, c in cal_lines],
        "calibration_seconds": counts["window_seconds"]["calibration"],
        "launches_in_calibration": {k: v for k, v in counts["windows"]["calibration"].items() if v},
        "blur4_bf16_in_disc_features": disc_blur,
        "blur4_bf16_shapes": counts["blur4_bf16_shapes"]}

    seconds, out, counts = study_run(work, ["identification", "--only", "ident_64px_kl32_s6_None", *base], 600)
    recs = study_records(work, "identification", ["ident_64px_kl32_s6_None"])
    check_study_launches(counts, "study identification", [n + BF16 for n in ("blur4", "upblur4", "upblur4_adj")])
    runs["identification"] = counts
    line["identification"] = {"process_seconds": seconds, "p_bit": recs["ident_64px_kl32_s6_None"]["measured_p_bit"],
                              "wall_s": recs["ident_64px_kl32_s6_None"]["wall_s"], "peak_bytes": counts["peak_bytes"]}

    # capacity on the cached recipe: the FID sweep (500 steps x 8 restarts, bf16) and the full-budget one
    seconds, out, counts = study_run(work, ["capacity", *base], 900)
    check(counts["windows"]["training"] == {n: 0 for n in counts["launches"]}, "capacity: trained again")
    with open(os.path.join(work, "result", "study_capacity_torch.json")) as f:
        recs = json.load(f)
    check([(r["key_len"], r["sigma"]) for r in recs] == [(32, 3.0), (32, 6.0), (64, 3.0), (64, 6.0)],
          f"capacity: points {[(r['key_len'], r['sigma']) for r in recs]}")
    finite = lambda v: isinstance(v, float) and abs(v) < float("inf")  # noqa: E731  (NaN fails too)
    for r in recs:
        check(all(finite(r[k]) for k in ("fid", "fid_disc", "watermark_lpips", "watermark_mse")),
              f"capacity: visibility {r}")
        full = f"{budget[budget.index('--steps') + 1]}/{budget[budget.index('--n') + 1]}"
        check(r["mean_bit_acc_full"] is not None and r["full_budget"] == full, f"capacity: full budget {r}")
    # the solves in bf16; the visibility LPIPS and the discriminator's features in float32
    check_study_launches(counts, "study capacity", [n + BF16 for n in ("blur4", "upblur4", "upblur4_adj")],
                         ("renders", "visibility", "disc_features"))
    vis = counts["windows"]["visibility"]
    check(vis["conv3x3_relu"] > 0 and vis["vgg_slice1_fwd"] > 0, f"capacity: visibility LPIPS launched {vis}")
    check(counts["windows"]["disc_features"]["blur4"] > 0, "capacity: disc features without blur4")
    runs_capacity = counts
    line["capacity"] = {
        "process_seconds": seconds, "peak_bytes": counts["peak_bytes"], "samples": recs[0]["samples"],
        "sweep_seconds": [float(v) for v in re.findall(r"capacity sweep \([0-9/]+(?:, FID)?\) in ([0-9.]+)s", out)],
        "frechet_seconds": counts["window_seconds"]["frechet"], "frechet_calls": counts["window_calls"]["frechet"],
        "inception_seconds": counts["window_seconds"]["inception"], "inception_images": counts["inception_images"],
        "inception_images_per_s": counts["inception_images"] / counts["window_seconds"]["inception"],
        "records": [{k: r[k] for k in ("key_len", "sigma", "fid", "fid_disc", "watermark_lpips", "watermark_mse",
                                       "mean_bit_acc", "mean_bit_acc_full", "mean_latent_cos")} for r in recs]}

    seconds, out, counts = study_run(work, perceptual, 300)
    check(all(f"[study] {t}: cached" in out for t in tags), "resume: not every point was cached")
    check("ready in" not in out and not any(counts["launches"].values()),
          f"resume: trained or launched {counts['launches']}")
    line["resume"] = {"process_seconds": seconds, "launches": sum(counts["launches"].values())}

    seconds, out, _ = study_run(work, ["robustness", "perceptual", "identification", "capacity"], 120,
                                module="report")
    for head in ("## study_robustness (1 points)", "## study_perceptual (5 points)",
                 "## study_identification (1 points)", "## study_capacity (4 points)"):
        check(head in out, f"report: no '{head}'")
    line["report_seconds"] = seconds
    line["gpu"] = gpu
    emit(line)
    shutil.rmtree(work, ignore_errors=True)
    return ({n: sum(c["launches"][n] for c in runs.values()) for n in port["_cuda"].KERNELS},
            runs_capacity["launches"])


EVALUATE = ["--device", "cuda", "--random_init", "--img_size", "256", "--style_dim", "512", "--n_mlp", "8",
            "--channel_max", "512", "--key_lens", "64", "--sigmas", "1.0", "--samples", "2", "--steps", "20",
            "--n", "4", "--with_fid", "--loss", "perceptual"]


def rel_err(torch, got, want) -> float:
    """max |got - want| / max |want|, on the CPU in float32."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def phase_evaluate(torch, port, gpu, device="cuda", argv=EVALUATE, squeeze_argv=FULL):
    """Phase 17: ``cli.evaluate --with_fid`` at full width (float32,
    perceptual): every float32 kernel launched, finite FID and visibility, the
    content latent's cosine; the host seconds of its Frechet distance.  Then
    Inception alone at 299 px (batch 16: CUDA-event median, images/s; batch 2
    and ``preprocess`` against the CPU), the AlexNet and SqueezeNet backbones
    and the three distance modes at (2, 256, 256, 3) against the CPU (1e-4 of
    the CPU side's largest magnitude: cuDNN's float32 sums in another order),
    the train-mode attacks at each fixed draw against the CPU (1e-5), and one
    ``cli.attribute --lpips_net squeeze`` run (2 x 4 chains, 10 steps): the
    FIR kernels launched, no LPIPS kernel."""
    cuda_mod, fid, inc, lp, atk = port["_cuda"], port["fid"], port["inception"], port["lpips"], port["attacks"]
    out = os.path.join(OUT, "evaluate.json")
    frechet, host = fid.frechet_distance, {"seconds": 0.0, "calls": 0}

    def timed_frechet(*args, **kwargs):
        t = time.time()
        try:
            return frechet(*args, **kwargs)
        finally:
            host["seconds"] += time.time() - t
            host["calls"] += 1

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_mod.reset_launches()
    fid.frechet_distance = timed_frechet
    t0 = time.time()
    try:
        rc = port["cli_evaluate"].main(argv + ["--out", out])
    finally:
        fid.frechet_distance = frechet
    torch.cuda.synchronize()
    seconds = time.time() - t0
    counts = cuda_mod.launch_counts()
    check(rc == 0, f"cli.evaluate returned {rc}")
    with open(out) as f:
        recs = json.load(f)
    check(len(recs) == 1, f"cli.evaluate: records {recs}")
    rec = recs[0]
    for k in ("fid", "watermark_lpips", "watermark_mse", "mean_latent_cos", "mean_bit_acc"):
        check(isinstance(rec[k], float) and abs(rec[k]) < float("inf"), f"cli.evaluate: {k} = {rec[k]}")
    check(host["calls"] == 1, f"cli.evaluate: {host['calls']} Frechet distances")
    check_all_launched(counts, "cli.evaluate")
    line = {"phase": "evaluate", "img_size": 256, "style_dim": 512, "n_mlp": 8, "channel_max": 512, "key_len": 64,
            "sigma": 1.0, "samples": 2, "steps": 20, "restarts": 4, "loss": "perceptual", "dtype": "float32",
            "process_seconds": seconds, "frechet_seconds": host["seconds"], "record": rec,
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(), "launches": counts}

    # Inception alone: batch 16 timed; batch 2 and the resize against the CPU
    g = torch.Generator().manual_seed(11)
    params = inc.init_inception_params(g, device)
    params_cpu = port["tree"].tree_map(lambda t: t.cpu(), params)
    x16 = (torch.rand((16, 299, 299, 3), generator=g) * 2 - 1).to(device)
    with torch.no_grad():
        ms = median_ms(torch, lambda: inc.inception_features(params, x16), reps=10)
        line["inception_batch16_ms"] = ms
        line["inception_images_per_s"] = 16 / ms * 1000.0
        line["inception_err"] = rel_err(torch, inc.inception_features(params, x16[:2]),
                                        inc.inception_features(params_cpu, x16[:2].cpu()))
        check(line["inception_err"] <= TOL, f"inception card vs CPU {line['inception_err']:.3e}")
        for size in (256, 512):  # an upscale, and a downscale (antialiased)
            img = torch.rand((2, size, size, 3), generator=g) * 2 - 1
            err = float((inc.preprocess(img.to(device)).cpu() - inc.preprocess(img)).abs().max())
            line[f"preprocess_{size}_max_abs_err"] = err
            # the antialiased downscale sums up to ~5 taps a pass in another order on the card
            check(err <= TOL, f"preprocess {size} -> 299 card vs CPU {err:.3e}")

        # the other LPIPS backbones and the distance modes
        yy, xx = torch.meshgrid(torch.linspace(-1, 1, 256), torch.linspace(-1, 1, 256), indexing="ij")
        base = torch.stack([torch.sin(3 * xx + p) * torch.cos(2 * yy - p) for p in (0.0, 1.0, 2.0)], -1)
        a = torch.clamp(0.8 * base[None] + 0.25 * torch.randn((2, 256, 256, 3), generator=g), -1.0, 1.0)
        b = torch.clamp(a + 0.2 * torch.randn(a.shape, generator=g), -1.0, 1.0)
        for net in ("alex", "squeeze"):
            p_card = lp.build_lpips_params(torch.Generator().manual_seed(0), device, net=net)
            p_cpu = lp.build_lpips_params(torch.Generator().manual_seed(0), "cpu", net=net)
            feats = getattr(lp, {"alex": "alexnet_features", "squeeze": "squeezenet_features"}[net])
            errs = [rel_err(torch, fc, fh) for fc, fh in zip(feats(p_card["net"], lp.scaling_layer(a.to(device))),
                                                           feats(p_cpu["net"], lp.scaling_layer(a)))]
            line[f"{net}_features_err"] = max(errs)
            line[f"{net}_net_mode_err"] = rel_err(torch, lp.lpips_net_mode(p_card, a.to(device), b.to(device)),
                                                  lp.lpips_net_mode(p_cpu, a, b))
            check(max(errs) <= TOL and line[f"{net}_net_mode_err"] <= TOL,
                  f"{net}: card vs CPU {max(errs):.3e}, net mode {line[f'{net}_net_mode_err']:.3e}")
        for mode in ("dssim_per_sample", "mse_per_sample"):
            fn = getattr(lp, mode)
            line[f"{mode}_err"] = rel_err(torch, fn(a.to(device), b.to(device)), fn(a, b))
            check(line[f"{mode}_err"] <= TOL, f"{mode}: card vs CPU {line[mode + '_err']:.3e}")

        # the train-mode attacks at every fixed draw
        errs = {}
        for choice in (0, 1, 2):
            errs[f"blur_random_{choice}"] = float((atk.gaussian_blur_random(a.to(device), choice=choice).cpu()
                                                   - atk.gaussian_blur_random(a, choice=choice)).abs().max())
        ch = int(256 * 0.9)
        for off in ((0, 0), (256 - ch, 256 - ch), (3, 17)):
            errs[f"random_crop_{off[0]}_{off[1]}"] = float((atk.random_crop(a.to(device), offset=off).cpu()
                                                           - atk.random_crop(a, offset=off)).abs().max())
        line["train_attack_max_abs_err"] = errs
        check(max(errs.values()) <= 1e-5, f"train-mode attacks card vs CPU {errs}")

    # the solver on a SqueezeNet LPIPS: the generator's FIR kernels, no VGG kernel
    cuda_mod.reset_launches()
    r = port["cli_attribute"].run(squeeze_argv + ["--loss", "perceptual", "--lpips_net", "squeeze", "--sample_size",
                                                  "2", "--n", "4", "--steps", "10",
                                                  "--save_dir", os.path.join(OUT, "squeeze")])
    sq = cuda_mod.launch_counts()
    check(all(sq[n] > 0 for n in ("blur4", "upblur4", "upblur4_adj")), f"squeeze solve: FIR launches {sq}")
    check(all(sq[n] == 0 for n in ("conv3x3_relu", "vgg_slice1_fwd", "vgg_slice1_bwd")), f"squeeze solve: {sq}")
    check(all(v == v and abs(v) < float("inf") for v in r.losses), f"squeeze solve: losses {r.losses}")
    line["squeeze_attribute"] = {"solve_seconds": r.solve_seconds, "losses": r.losses, "launches": sq}
    line["gpu"] = gpu
    emit(line)
    return counts


# phase 18: the runs both ranks make, and that this process repeats on one device
PARALLEL_ATTRIBUTE = FULL + ["--loss", "perceptual", "--sample_size", "2", "--n", "4"]
PARALLEL_TRAIN = ["--device", "cuda", "--img_size", "64", "--channel_max", "128", "--batch", "16", "--steps", "8",
                  "--chunk", "8", "--seed", "0", "--out", ""]
# the 1-step runs' losses (the loss at the restarts' starts): one float32 computation at batch 4 (a rank)
# and 8 (one process), which may take other cuBLAS / cuDNN algorithms.  The 10-step runs' losses are
# printed, not held: Adam's first steps are ~lr * sign(g), so a rounding difference in a near-zero
# gradient moves a coordinate by 2 * lr and free solves part (on this phase's first chip run: 0.8% and
# 10%; on the CPU, 1.2e-7 relative at step 1 grows to 4.4e-4 at step 10 between batch 8 and 2 x 4)
PARALLEL_LOSS_RTOL = 1e-4
PARALLEL_TRAIN_TOL = dict(rtol=2e-2, atol=1e-3)  # the reference package's tests/test_training_mesh.py
PARALLEL_COLLECTIVE_TIMEOUT_S = 180
# batch 4 on two ranks: one minibatch-stddev group, so each rank holds 2 contiguous rows and the
# discriminator gathers them at its stddev layer; 4 steps, R1 at step 0 (the later flags rule)
PARALLEL_TRAIN_GATHER = PARALLEL_TRAIN + ["--batch", "4", "--steps", "4", "--chunk", "4"]
# BigGAN-deep-256 on a 1 x 2 mesh (every rank is on the model axis): replicated, as the reference places it
BIGGAN_MODEL_AXIS = ["--mesh_data", "0", "--mesh_model", "2"]
BIGGAN_PARALLEL_ATTRIBUTE = BIGGAN_FULL + ["--loss", "perceptual", "--sample_size", "2", "--n", "4", "--steps", "1"]
LPIPS_KERNELS = ("conv3x3_relu", "vgg_slice1_fwd", "vgg_slice1_bwd")
FIR_KERNELS = ("blur4", "upblur4", "upblur4_adj")


def png_arrays(root: str) -> dict:
    """The PNGs of the one run directory under ``root`` by category and name
    (``watermarked/000000.png``: the directory's name is its time), as uint8 arrays."""
    import numpy as np
    from PIL import Image

    return {os.path.join(os.path.basename(d), f): np.asarray(Image.open(os.path.join(d, f)))
            for d, _, fs in os.walk(root) for f in fs if f.endswith(".png")}


def parallel_worker(work: str) -> int:
    """One rank of phase 18 (started by ``torch.distributed.run``, two ranks
    on the one card): ``cli.attribute --mesh_data 2`` at full width, the tiny
    configuration's planted keys through ``attribute_on_mesh``, ``cli.train
    --mesh_data 2`` at batch 16 (whole minibatch-stddev groups a rank) and 4
    (rows gathered at the stddev layer), BigGAN's ``cli.generate`` /
    ``cli.attribute --mesh_model 2``; cuDNN held to its deterministic
    algorithms.  Writes ``rank<r>.json`` into ``work``."""
    import torch

    port = import_port()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    global BF16
    BF16 = port["roof"].BF16_SUFFIX
    t_start = time.time()
    mh, cuda_mod = port["multihost"], port["_cuda"]
    # a collective left waiting this long raises: a rank out of step fails the phase, never hangs it
    device = mh.initialize(device="cuda", timeout=PARALLEL_COLLECTIVE_TIMEOUT_S)
    rank = mh.process_index()
    rec = {"rank": rank, "world": mh.process_count(), "device": str(device),
           "backend": torch.distributed.get_backend(), "local_rank": int(os.environ["LOCAL_RANK"])}
    cuda_mod.reset_launches()
    t0 = time.time()
    r = port["cli_attribute"].run(PARALLEL_ATTRIBUTE + ["--steps", "10", "--mesh_data", "2",
                                                        "--save_dir", os.path.join(work, "attribute_mesh")])
    rec["attribute"] = {"bit_acc": r.bit_accs, "losses": r.losses, "run_dir": r.run_dir,
                        "solve_seconds": r.solve_seconds, "seconds": time.time() - t0,
                        "launches": cuda_mod.launch_counts()}
    check_all_launched(rec["attribute"]["launches"], f"rank {rank}'s cli.attribute --mesh_data 2")
    r = port["cli_attribute"].run(PARALLEL_ATTRIBUTE + ["--steps", "1", "--mesh_data", "2",
                                                        "--save_dir", os.path.join(work, "attribute_mesh_1")])
    rec["attribute_1"] = {"bit_acc": r.bit_accs, "losses": r.losses}

    C, pl, ps = port["config"], port["pipeline"], port["psolver"]
    t0 = time.time()
    mcfg = C.ModelConfig(**TINY)
    pipe = pl.build_pipeline(mcfg, C.FingerprintConfig(key_len=8, shift=56, n_pca_samples=2000),
                             generator=torch.Generator().manual_seed(TINY_SEED), device=device, want_lpips=False)
    imgs, _, _, bits, _ = pl.generate_fingerprinted(pipe, 4, torch.Generator().manual_seed(TINY_SEED + 1))
    res = ps.attribute_on_mesh(port["pmesh"].make_mesh(data=2), pipe.gen_params, None, pipe.basis, pipe.noise, imgs,
                               mcfg=mcfg, acfg=C.AttributionConfig(steps=300, n_starts=4, lr=0.2, loss="mse"),
                               generator=torch.Generator().manual_seed(TINY_SEED + 2))
    rec["recovery"] = {"bit_acc": [float(a) for a in port["attribute"].evaluate_attribution(res, bits)["bit_acc"]],
                       "key_bits": res.key_bits.cpu().tolist(), "seconds": time.time() - t0}

    t0 = time.time()
    metrics = os.path.join(work, f"train_mesh_{rank}.jsonl")
    check(port["cli_train"].main(PARALLEL_TRAIN + ["--mesh_data", "2", "--metrics_out", metrics]) == 0,
          "cli.train --mesh_data 2")
    rec["train"] = {"rows": [json.loads(ln) for ln in open(metrics)] if rank == 0 else [],
                    "seconds": time.time() - t0}
    t0 = time.time()
    metrics = os.path.join(work, f"train_gather_{rank}.jsonl")
    cuda_mod.reset_launches()
    check(port["cli_train"].main(PARALLEL_TRAIN_GATHER + ["--mesh_data", "2", "--metrics_out", metrics]) == 0,
          "cli.train --mesh_data 2 --batch 4")
    launches = cuda_mod.launch_counts()
    check(all(launches[n] > 0 for n in FIR_KERNELS), f"rank {rank}'s cli.train --batch 4: FIR launches {launches}")
    rec["train_gather"] = {"rows": [json.loads(ln) for ln in open(metrics)] if rank == 0 else [],
                           "seconds": time.time() - t0, "launches": launches}
    # the row gather alone, and with its backward (the all_reduce and slice), at that run's stddev
    # layer (2 rows a rank, 4 x 4 x 128): a step without R1 makes three of each
    pmesh, x = port["pmesh"], torch.randn(2, 4, 4, 128, device=device, requires_grad=True)
    mesh2 = pmesh.make_mesh(data=2)

    def ms_per_call(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / reps * 1e3

    rec["train_gather"]["gather_ms"] = ms_per_call(lambda: pmesh.gather_rows(x, mesh2))
    rec["train_gather"]["gather_and_backward_ms"] = ms_per_call(
        lambda: torch.autograd.grad(pmesh.gather_rows(x, mesh2).sum(), x))

    # BigGAN on the model axis: the reference shards no BigGAN leaf, so every rank runs the whole
    # network; the library's generation against one process on this rank, then both CLIs
    t0 = time.time()
    mesh12 = port["pmesh"].make_mesh(data=1, model=2)
    bpipe = pl.build_pipeline(C.ModelConfig(**BIGGAN_MCFG), C.FingerprintConfig(key_len=32, shift=96),
                              generator=torch.Generator().manual_seed(0), device=device, want_lpips=False)
    placed = ps.place_pipeline(mesh12, bpipe, shard_model=True)
    check(placed.gen_params is bpipe.gen_params, "BigGAN's generator was not replicated on the 1 x 2 mesh")
    imgs_tp = ps.generate_on_mesh(mesh12, placed, 2, torch.Generator().manual_seed(11))[0]
    imgs_one = pl.generate_fingerprinted(bpipe, 2, torch.Generator().manual_seed(11))[0]
    err = float((imgs_tp - imgs_one).abs().max()) / max(1.0, float(imgs_one.abs().max()))
    check(err <= TOL, f"rank {rank}: BigGAN on the 1 x 2 mesh is {err:.3g} (of max) from one process")
    check(port["cli_generate"].main(BIGGAN_FULL + BIGGAN_MODEL_AXIS + [
        "--sample_size", "1", "--save_dir", os.path.join(work, "biggan_generate_tp")]) == 0,
        "cli.generate --model biggan --mesh_model 2")
    cuda_mod.reset_launches()
    r = port["cli_attribute"].run(BIGGAN_PARALLEL_ATTRIBUTE + BIGGAN_MODEL_AXIS + [
        "--save_dir", os.path.join(work, "biggan_attribute_tp")])
    launches = cuda_mod.launch_counts()
    check_all_launched({n: launches[n] for n in LPIPS_KERNELS}, f"rank {rank}'s BigGAN cli.attribute --mesh_model 2")
    check(all(launches[n] == 0 for n in FIR_KERNELS), f"rank {rank}'s BigGAN solve launched {launches}")
    rec["biggan_model_axis"] = {"max_err_of_max": err, "bit_acc": r.bit_accs, "losses": r.losses,
                                "launches": launches, "seconds": time.time() - t0}

    # the model axis: generation on a 1 x 2 mesh (each rank half of every styled conv's output
    # channels) against the unsharded generator, and the shapes blur4 was launched at
    t0 = time.time()
    up, launch = port["up_cuda"], port["up_cuda"].blur4_launch
    shapes = []

    def recording(x, *args):
        shapes.append(tuple(x.shape))
        return launch(x, *args)

    pipe = pl.build_pipeline(C.ModelConfig(img_size=256), C.FingerprintConfig(key_len=64, shift=448),
                             generator=torch.Generator().manual_seed(0), device=device, want_lpips=False)
    mesh12 = port["pmesh"].make_mesh(data=1, model=2)
    placed = ps.place_pipeline(mesh12, pipe, shard_model=True)
    up.blur4_launch = recording
    try:
        imgs_tp = ps.generate_on_mesh(mesh12, placed, 2, torch.Generator().manual_seed(11))[0]
        sharded_shapes, shapes[:] = list(shapes), []
        imgs_one = pl.generate_fingerprinted(pipe, 2, torch.Generator().manual_seed(11))[0]
        full_shapes = list(shapes)
    finally:
        up.blur4_launch = launch
    err = float((imgs_tp - imgs_one).abs().max()) / max(1.0, float(imgs_one.abs().max()))
    check(err <= TOL, f"rank {rank}: the 1 x 2 mesh's images are {err:.3g} (of max) from the unsharded ones")
    check(sorted(sharded_shapes) == sorted(s[:3] + (s[3] // 2,) for s in full_shapes),
          f"blur4 on the 1 x 2 mesh at {sharded_shapes}, unsharded at {full_shapes}")
    rec["model_axis"] = {"max_err_of_max": err, "blur4_shapes": sharded_shapes, "seconds": time.time() - t0}

    # the engine on the 2-rank data mesh: rank 0 serves HTTP, rank 1 follows its batches
    t0 = time.time()
    engine, server = port["cli_serve"].build_server(FULL + ["--loss", "perceptual", "--buckets", "2", "--steps", "10",
                                                            "--n", "4", "--port", "0", "--mesh_data", "2"])
    if server is None:
        engine.follow()
        rec["serve"] = {"follower": True, "seconds": time.time() - t0}
    else:
        import base64

        import numpy as np

        port["server"].serve_forever_in_thread(server)
        base = "http://%s:%d" % server.server_address[:2]
        try:
            gen, gen_ms = _http("POST", base + "/v1/generate", {"seed": 7, "encoding": "float_list"})
            img = np.asarray(gen["image"], dtype=np.float32)
            buf = io.BytesIO()
            np.save(buf, img)
            dec, dec_ms = _http("POST", base + "/v1/attribute",
                                {"image_npy_b64": base64.b64encode(buf.getvalue()).decode()})
            stats, _ = _http("GET", base + "/v1/stats")
        finally:
            server.shutdown()
            server.server_close()
            engine.stop()
        check(img.shape == (256, 256, 3) and len(gen["key_bits"]) == 64 and len(dec["key_bits"]) == 64,
              f"served shapes {img.shape}, {len(gen['key_bits'])}, {len(dec['key_bits'])}")
        check(dec["loss"] is not None and stats["generate"]["batches"] == stats["attribute"]["batches"] == 1,
              f"served attribution loss {dec['loss']}, stats {stats}")
        rec["serve"] = {"generate_ms": gen_ms, "attribute_ms": dec_ms, "bit_acc_of_served_image": sum(
            a == b for a, b in zip(gen["key_bits"], dec["key_bits"])) / 64, "loss": dec["loss"],
            "seconds": time.time() - t0}
    rec["seconds"] = time.time() - t_start
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    torch.distributed.destroy_process_group()
    return 0


def blur4_half_channel_rows(torch, port) -> dict:
    """blur4 at the main path's forward shapes with half the channels (the
    shapes a rank of a 1 x 2 mesh launches), batch 16: each shape against its
    plain version (within ``TOL`` of max), and the launch function's, the plain
    version's and the depthwise ``F.conv2d``'s times beside the bound, summed."""
    import torch.nn.functional as F

    up, upf, roof = port["up_cuda"], port["upf"], port["roof"]
    k1 = upf.split_symmetric_4tap(upf.make_kernel((1, 3, 3, 1)) * 4.0)
    kt = torch.tensor(k1, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for c, h in roof.BLUR4_SHAPES:
        c //= 2
        x = torch.randn(16, h + 1, h + 1, c, device="cuda", generator=g)
        wl = torch.outer(kt, kt).flip(0, 1).expand(c, 1, 4, 4).contiguous()
        kf = lambda x=x: up.blur4_launch(x, k1[::-1], k1[::-1], (1, 1), (1, 1))  # noqa: E731
        pf = lambda x=x: up.blur4_plain(x, k1, k1, (1, 1), (1, 1))  # noqa: E731
        lf = lambda x=x, wl=wl, c=c: F.conv2d(x.permute(0, 3, 1, 2), wl, padding=1, groups=c)  # noqa: E731
        want = pf()
        err = float((kf() - want).abs().max()) / max(1.0, float(want.abs().max()))
        check(err <= TOL, f"blur4 at C{c}_H{h}: {err:.3g} of max from its plain version")
        bound = roof.blur4(16, c, h, h)
        rows[f"C{c}_H{h}"] = {"ms": median_ms(torch, kf), "plain_ms": median_ms(torch, pf),
                              "library_ms": median_ms(torch, lf), "bound_ms": bound["bound_ms"],
                              "bound_by": bound["bound_by"], "max_abs_err": err}
    total = {k: sum(r[k] for r in rows.values()) for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    return {"batch": 16, "shapes": rows, **total, "max_abs_err": max(r["max_abs_err"] for r in rows.values())}


def phase_parallel(torch, port, gpu):
    """Two ranks on the one card over gloo (``torch.distributed.run``, the
    worker above) against the same runs in this process: ``cli.attribute
    --mesh_data 2`` (equal bit accuracies, 1-step losses within
    ``PARALLEL_LOSS_RTOL``, every float32 kernel launched by each rank), the
    tiny planted keys through ``attribute_on_mesh`` (phase 3's criterion on 4
    samples), ``cli.train --mesh_data 2`` at batch 16 and at batch 4 (rows
    gathered at the stddev layer; metrics as the reference's mesh test
    compares them), BigGAN's ``cli.generate`` (PNGs within a level) and 1-step
    ``cli.attribute`` (``PARALLEL_LOSS_RTOL``) with ``--mesh_model 2``; the
    model axis and the served engine as the worker checks them.  The nccl
    route (a card a rank) needs a second card."""
    work = os.path.join(ROOT, "_chip_work", "parallel")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t_start = time.time()
    r = run_child([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
                   os.path.join(ROOT, "chip_smoke.py"), "--parallel-worker", work], 600, cwd=ROOT)
    launch_seconds = time.time() - t_start
    print(r.stdout[-6000:], end="", flush=True)
    check(r.returncode == 0, f"the two-rank run returned {r.returncode}: {r.stderr[-3000:]}")
    ranks = []
    for rank in range(2):
        with open(os.path.join(work, f"rank{rank}.json")) as f:
            ranks.append(json.load(f))
    check([x["backend"] for x in ranks] == ["gloo", "gloo"] and [x["device"] for x in ranks] == ["cuda:0", "cuda:0"],
          f"backends / devices {[(x['backend'], x['device']) for x in ranks]}")
    a0, a1 = ranks[0]["attribute"], ranks[1]["attribute"]
    for key in ("attribute", "attribute_1"):
        check(all(ranks[0][key][k] == ranks[1][key][k] for k in ("bit_acc", "losses")),
              f"the ranks disagree on the result of {key}")
    check(os.path.exists(os.path.join(a0["run_dir"], "result.txt")), "rank 0 wrote no result.txt")
    check(len(os.listdir(os.path.join(work, "attribute_mesh", "None", "fixed_sigma_10", "shift_448"))) == 1,
          "more than one run directory: only rank 0 writes")

    det = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        t0 = time.time()
        single = port["cli_attribute"].run(PARALLEL_ATTRIBUTE + ["--steps", "10",
                                                                 "--save_dir", os.path.join(work, "attribute_one")])
        single_seconds = time.time() - t0
        single_1 = port["cli_attribute"].run(PARALLEL_ATTRIBUTE + ["--steps", "1",
                                                                   "--save_dir", os.path.join(work, "attribute_one_1")])
        metrics = os.path.join(work, "train_one.jsonl")
        check(port["cli_train"].main(PARALLEL_TRAIN + ["--metrics_out", metrics]) == 0, "cli.train")
        t0 = time.time()
        metrics_gather = os.path.join(work, "train_gather_one.jsonl")
        check(port["cli_train"].main(PARALLEL_TRAIN_GATHER + ["--metrics_out", metrics_gather]) == 0,
              "cli.train --batch 4")
        gather_single_seconds = time.time() - t0
        t0 = time.time()
        check(port["cli_generate"].main(BIGGAN_FULL + ["--sample_size", "1", "--save_dir",
                                                       os.path.join(work, "biggan_generate_one")]) == 0,
              "cli.generate --model biggan")
        biggan_1 = port["cli_attribute"].run(BIGGAN_PARALLEL_ATTRIBUTE + [
            "--save_dir", os.path.join(work, "biggan_attribute_one")])
        biggan_single_seconds = time.time() - t0
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det
    check(a0["bit_acc"] == single.bit_accs, f"bit accuracies {a0['bit_acc']} on two ranks, {single.bit_accs} on one")
    b1 = ranks[0]["attribute_1"]
    check(b1["bit_acc"] == single_1.bit_accs, f"1 step: bit accuracies {b1['bit_acc']} on two ranks, "
          f"{single_1.bit_accs} on one")
    loss_rel_1 = max(abs(a - b) / abs(b) for a, b in zip(b1["losses"], single_1.losses))
    check(loss_rel_1 <= PARALLEL_LOSS_RTOL, f"1 step: losses {b1['losses']} on two ranks, {single_1.losses} on one")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(a0["losses"], single.losses))

    rec0, rec1 = ranks[0]["recovery"], ranks[1]["recovery"]
    accs = rec0["bit_acc"]
    check(rec0 == {**rec1, "seconds": rec0["seconds"]}, "the ranks disagree on the planted keys")
    check(sum(accs) / 4 > 0.85 and sum(a >= 1.0 for a in accs) >= 3, f"planted keys on two ranks: {accs}")

    def train_rel_diff(mesh_rows, path, steps, tag):
        one = [json.loads(ln) for ln in open(path)]
        check([x["step"] for x in mesh_rows] == list(range(1, steps + 1)) == [x["step"] for x in one],
              f"{tag}: metric rows")
        rel = 0.0
        for a, b in zip(mesh_rows, one):
            for k in ("d_loss", "r1", "g_loss"):
                err = abs(a[k] - b[k])
                check(err <= PARALLEL_TRAIN_TOL["atol"] + PARALLEL_TRAIN_TOL["rtol"] * abs(b[k]),
                      f"{tag} step {a['step']} {k}: {a[k]} on two ranks, {b[k]} on one")
                rel = max(rel, err / max(abs(b[k]), 1e-12))
        return rel, one

    mesh_rows = ranks[0]["train"]["rows"]
    train_rel, one = train_rel_diff(mesh_rows, metrics, 8, "cli.train --batch 16")
    gather_rows = ranks[0]["train_gather"]["rows"]
    gather_rel, gather_one = train_rel_diff(gather_rows, metrics_gather, 4, "cli.train --batch 4")
    check(gather_rows[0]["r1"] > 0 and gather_one[0]["r1"] > 0, "cli.train --batch 4: no R1 at step 0")

    bg = [x["biggan_model_axis"] for x in ranks]
    check(bg[0]["bit_acc"] == bg[1]["bit_acc"] and bg[0]["losses"] == bg[1]["losses"],
          "the ranks disagree on BigGAN's --mesh_model 2 solve")
    check(bg[0]["bit_acc"] == biggan_1.bit_accs, f"BigGAN --mesh_model 2: bit accuracies {bg[0]['bit_acc']}, "
          f"{biggan_1.bit_accs} in one process")
    biggan_loss_rel = max(abs(a - b) / abs(b) for a, b in zip(bg[0]["losses"], biggan_1.losses))
    check(biggan_loss_rel <= PARALLEL_LOSS_RTOL, f"BigGAN --mesh_model 2: 1-step losses {bg[0]['losses']}, "
          f"{biggan_1.losses} in one process")
    # rank 0 wrote the 1 x 2 mesh's PNGs: float images within TOL round to within one level of 255
    png_tp, png_one = (png_arrays(os.path.join(work, d)) for d in ("biggan_generate_tp", "biggan_generate_one"))
    check(len(png_tp) == 4 and sorted(png_tp) == sorted(png_one), f"BigGAN PNGs {sorted(png_tp)} vs {sorted(png_one)}")
    png_diff = max(int(abs(png_tp[k].astype(int) - png_one[k].astype(int)).max()) for k in png_tp)
    check(png_diff <= 1, f"BigGAN cli.generate --mesh_model 2: PNGs {png_diff} levels from one process's")
    shutil.rmtree(work, ignore_errors=True)
    model_axis = [x["model_axis"] for x in ranks]
    serve = next(x["serve"] for x in ranks if not x["serve"].get("follower"))
    out = {"phase": "parallel", "world": 2, "backend": [x["backend"] for x in ranks],
           "devices": [x["device"] for x in ranks], "nccl": "not reachable: one card",
           "attribute": {"bit_acc": a0["bit_acc"], "losses": a0["losses"], "single_losses": single.losses,
                         "max_loss_rel_diff": loss_rel, "losses_1_step": b1["losses"],
                         "single_losses_1_step": single_1.losses, "max_loss_rel_diff_1_step": loss_rel_1,
                         "loss_rtol_1_step": PARALLEL_LOSS_RTOL,
                         "solve_seconds_per_rank": [x["attribute"]["solve_seconds"] for x in ranks],
                         "single_solve_seconds": single.solve_seconds, "single_seconds": single_seconds},
           "recovery": {"bit_acc": accs, "exact": sum(a >= 1.0 for a in accs), "seconds": rec0["seconds"]},
           "train": {"steps": 8, "max_metric_rel_diff": train_rel, "tolerance": PARALLEL_TRAIN_TOL,
                     "d_loss_last": [mesh_rows[-1]["d_loss"], one[-1]["d_loss"]]},
           "train_gather": {"batch": 4, "steps": 4, "max_metric_rel_diff": gather_rel,
                            "tolerance": PARALLEL_TRAIN_TOL, "r1_step_1": [gather_rows[0]["r1"], gather_one[0]["r1"]],
                            "d_loss_last": [gather_rows[-1]["d_loss"], gather_one[-1]["d_loss"]],
                            "steps_per_s_chunk": [gather_rows[0]["chunk_steps_per_s"],
                                                  gather_one[0]["chunk_steps_per_s"]],
                            "gather_ms": [x["train_gather"]["gather_ms"] for x in ranks],
                            "gather_and_backward_ms": [x["train_gather"]["gather_and_backward_ms"] for x in ranks],
                            "seconds_per_rank": [x["train_gather"]["seconds"] for x in ranks],
                            "single_seconds": gather_single_seconds},
           "biggan_model_axis": {"library_max_err_of_max": [b["max_err_of_max"] for b in bg],
                                 "png_max_level_diff": png_diff, "bit_acc": bg[0]["bit_acc"],
                                 "losses_1_step": bg[0]["losses"], "single_losses_1_step": biggan_1.losses,
                                 "max_loss_rel_diff_1_step": biggan_loss_rel,
                                 "seconds_per_rank": [b["seconds"] for b in bg],
                                 "single_seconds": biggan_single_seconds},
           "model_axis": {"max_err_of_max": [m["max_err_of_max"] for m in model_axis],
                          "blur4_shapes": model_axis[0]["blur4_shapes"],
                          "seconds": [m["seconds"] for m in model_axis]},
           "blur4_half_channels": blur4_half_channel_rows(torch, port), "serve": serve,
           "launches_per_rank": [x["attribute"]["launches"] for x in ranks],
           "launches_per_rank_train_gather": [x["train_gather"]["launches"] for x in ranks],
           "launches_per_rank_biggan_model_axis": [b["launches"] for b in bg],
           "rank_seconds": [x["seconds"] for x in ranks], "launch_seconds": launch_seconds,
           "seconds": time.time() - t_start, "gpu": gpu}
    emit(out)
    return {"attribute": [x["attribute"]["launches"] for x in ranks],
            "train_gather": [x["train_gather"]["launches"] for x in ranks],
            "biggan_model_axis": [b["launches"] for b in bg]}


def import_port() -> dict:
    """The port's modules that the phases drive, by short name."""
    import importlib

    sys.path.insert(0, ROOT)
    return {name: importlib.import_module(f"{PORT}.{mod}") for name, mod in (
        ("_cuda", "ops._cuda"), ("up_cuda", "ops.upfirdn2d_cuda"), ("vgg_cuda", "ops.vgg_cuda"),
        ("slice_cuda", "ops.vgg_slice_cuda"), ("upf", "ops.upfirdn2d"), ("roof", "ops.roofline"),
        ("tf32", "ops.tf32"), ("config", "config"), ("attacks", "attacks"), ("lhs", "utils.lhs"),
        ("state", "checkpoints.state"),
        ("pipeline", "fingerprint.pipeline"), ("attribute", "fingerprint.attribute"),
        ("encoder", "fingerprint.encoder"), ("keys", "fingerprint.keys"), ("serving", "serving"),
        ("server", "serving.server"),
        ("cli_generate", "cli.generate"), ("cli_attribute", "cli.attribute"), ("cli_serve", "cli.serve"),
        ("cli_model_attribute", "cli.model_attribute"), ("model_attribution", "fingerprint.model_attribution"),
        ("biggan", "models.biggan"), ("lpips", "losses.lpips"), ("gan", "training.gan"),
        ("cli_train", "cli.train"), ("fid", "eval.fid"), ("inception", "eval.inception"),
        ("cli_evaluate", "cli.evaluate"), ("tree", "utils.tree"), ("multihost", "parallel.multihost"),
        ("pmesh", "parallel.mesh"), ("psolver", "parallel.solver"), ("profiling", "utils.profiling"))}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False); "
              "this smoke test runs only on a GPU", file=sys.stderr)
        return 2
    try:
        port = import_port()
    except ImportError as e:
        print(f"chip_smoke: the port's package is not beside this script ({e})", file=sys.stderr)
        return 2
    global BF16
    BF16 = port["roof"].BF16_SUFFIX
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    shutil.rmtree(OUT, ignore_errors=True)  # an earlier run's PNGs would be counted with this run's
    os.makedirs(OUT, exist_ok=True)

    start_watchdog()
    gpu = gpu_name_and_power()
    t0 = t_start = time.time()
    lib = port["_cuda"].build()
    port["_cuda"].library()
    import numpy

    emit({"phase": "device", "gpu": gpu, "torch": torch.__version__, "cuda": torch.version.cuda,
          "numpy": numpy.__version__, "python": sys.version.split()[0],
          "library": os.path.relpath(str(lib), ROOT), "build_seconds": time.time() - t0})

    mods = (port["up_cuda"], port["vgg_cuda"], port["slice_cuda"], port["upf"])
    per_kernel = phase_kernels(torch, mods, port["roof"].DISC_BLUR_SHAPES)
    phase_second_derivative(torch, mods, port["roof"].DISC_BLUR_SHAPES)
    phase_launch_times(torch, mods + (port["roof"],), per_kernel)
    emit({"phase": "kernels_done", "seconds": time.time() - t_start})
    phase_recovery(torch, port)
    phase_recovery(torch, port, "bfloat16")
    phase_generate(torch, port)
    counts, per_step, f32_line = phase_attribute(torch, port, gpu)
    t0 = time.time()
    per_step.update(phase_step16(torch, port, gpu))
    bf16_counts = phase_attribute_bf16(torch, port, gpu, f32_line)
    emit({"phase": "bf16_paths_done", "seconds": time.time() - t0})
    t0 = time.time()
    counts_1024, per_step_1024 = phase_attribute_1024(torch, port, gpu)
    emit({"phase": "attribute_1024_done", "seconds": time.time() - t0})
    phase_attacks(torch, port)
    phase_robust_recovery(torch, port)
    attacked_counts = phase_attacked_attribute(torch, port, gpu)
    t0 = time.time()
    encoder_counts = phase_encoder(torch, port, gpu)
    emit({"phase": "encoder_done", "seconds": time.time() - t0})
    t0 = time.time()
    attribute_encoder_counts = phase_attribute_encoder(torch, port, gpu)
    emit({"phase": "attribute_encoder_done", "seconds": time.time() - t0})
    t0 = time.time()
    serve_counts = phase_serve(torch, port, gpu)
    emit({"phase": "serve_done", "seconds": time.time() - t0})
    t0 = time.time()
    biggan_counts = phase_biggan(torch, port, gpu)
    emit({"phase": "biggan_done", "seconds": time.time() - t0})
    t0 = time.time()
    model_attribution_counts = phase_model_attribution(torch, port, gpu)
    studies_counts = phase_studies_bf16(torch, port, gpu)
    emit({"phase": "model_attribution_done", "seconds": time.time() - t0})
    t0 = time.time()
    training_counts = phase_train(torch, port, gpu)
    emit({"phase": "train_done", "seconds": time.time() - t0})
    t0 = time.time()
    phase_train_tiny(torch, port, gpu)
    emit({"phase": "train_tiny_done", "seconds": time.time() - t0})
    t0 = time.time()
    study_counts, capacity_counts = phase_studies(torch, port, gpu)
    emit({"phase": "studies_done", "seconds": time.time() - t0})
    t0 = time.time()
    evaluate_counts = phase_evaluate(torch, port, gpu)
    emit({"phase": "evaluate_done", "seconds": time.time() - t0})
    t0 = time.time()
    parallel_counts = phase_parallel(torch, port, gpu)
    emit({"phase": "parallel_done", "seconds": time.time() - t0, "total_seconds": time.time() - t_start})

    # where phase 2 held a kernel through a wrapper that another kernel shares: (case name, its error)
    through = {"vgg_slice1_fwd": ("vgg_slice1", "err_fwd"), "vgg_slice1_bwd": ("vgg_slice1", "err_dx"),
               "upblur4": ("upblur4", "err_fwd"), "upblur4_adj": ("upblur4", "err_dx")}
    kernels = []
    for name, k in port["_cuda"].KERNELS.items():
        bf16 = name.endswith(BF16)
        launch = per_kernel[("launch", name)]
        if bf16:  # held at the launch level only (phase 2's bf16 rows)
            err = launch["err"]
        else:
            base, which = through.get(name, (name, None))
            agg = per_kernel[base]
            err = max(launch["err"], agg[which] if which else max(agg["err_fwd"], agg["err_dx"]))
        # times: one launch of each distinct main-path shape at batch 16 (the 16-chain
        # solve), launch function only, summed over the shapes; for the bf16 skip chain,
        # whose main path is one launch each way, that launch (the one-level launches of
        # the six shapes summed under ``per_level_``)
        times = {key: launch[key] for key in ("ms", "plain_ms", "bound_ms", "library_ms")}
        times["bound_by"] = max(launch["bound_by"], key=launch["bound_by"].get)
        # the 1024px main path's shapes at batch 2, summed likewise (its skip chain's launch alone)
        px = {"px1024_" + key: launch["px1024_" + key] for key in ("ms", "plain_ms", "bound_ms", "library_ms")}
        px["px1024_bound_by"] = max(launch["px1024_bound_by"], key=launch["px1024_bound_by"].get)
        px["px1024_max_abs_err"] = launch["px1024_err"]
        if "chain_ms" in launch:
            times = {**{"per_level_" + key: v for key, v in times.items()},
                     **{key: launch["chain_" + key] for key in ("ms", "plain_ms", "bound_ms", "library_ms",
                                                                "bound_by", "back_to_back_ms", "device_ms")}}
            px = {**{k.replace("px1024_", "px1024_per_level_"): v for k, v in px.items()},
                  **{"px1024_" + key: launch["px1024_chain_" + key]
                     for key in ("ms", "plain_ms", "bound_ms", "library_ms", "bound_by", "back_to_back_ms",
                                 "device_ms")}}
        px["px1024_bitwise_deterministic"] = True  # phase 2 ran every 1024px launch twice and compared
        kernels.append({
            "name": name, "route": "cuda", "source": f"{PORT}/{k.source}", "replaces": k.replaces,
            # the main path of a _bf16 kernel is cli.attribute --dtype bfloat16
            "launches": (bf16_counts if bf16 else counts)[name], "launches_attacked_path": attacked_counts[name],
            "launches_encoder_training": encoder_counts[name],
            "launches_attribute_encoder_path": attribute_encoder_counts[name],
            "launches_served_attribution": serve_counts[name],
            "launches_biggan_attribution": biggan_counts[name],
            "launches_model_attribution": model_attribution_counts[name],
            "launches_training": training_counts[name],
            "launches_bf16_studies": studies_counts[name],
            "launches_studies": study_counts[name],
            "launches_capacity": capacity_counts[name],
            "launches_evaluate": evaluate_counts[name],
            "launches_parallel": [c[name] for c in parallel_counts["attribute"]],
            "launches_parallel_train_gather": [c[name] for c in parallel_counts["train_gather"]],
            "launches_parallel_biggan_model_axis": [c[name] for c in parallel_counts["biggan_model_axis"]],
            # the 1024px cli.attribute runs (float32 without and with --remat, bf16 with it), and a
            # solve step's launches there
            **{"launches_1024_" + tag: c[name] for tag, c in counts_1024.items()},
            "launches_per_step_1024": {tag: n[name] for tag, n in per_step_1024.items() if name in n},
            "max_abs_err": err, **times, "batch": 16,
            "launches_per_step": per_step[name],
            # the adjoint launches of the same kernel (blur4 `_adj`, conv3x3_relu `_dx`) and blur4 at
            # the discriminator's shapes (`disc_`, forward and `disc_adjoint_`), summed likewise
            **{k: v for k, v in launch.items() if k.startswith(("adjoint_", "disc_"))}, **px,
            **{k: v for k, v in launch.items() if k.startswith("px1024_adjoint_")},
        })
    print(gpu, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-worker"]:
        sys.exit(parallel_worker(sys.argv[2]))
    sys.exit(main())
