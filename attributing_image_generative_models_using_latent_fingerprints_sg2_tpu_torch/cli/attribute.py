"""Attribution CLI: generate fingerprinted targets with known keys, invert
all of them (every sample x every Latin-Hypercube restart as one batch),
and report per-sample bit accuracy and exact-match attribution accuracy in
``result.txt``, with the original and watermarked PNGs beside it.

Run:
    python -m attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.cli.attribute \
        --device cuda --random_init --img_size 256 --key_len 64 --shift 448 \
        --loss perceptual --sample_size 2 --n 4 --steps 20
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import List

import torch

from ..fingerprint import attribute as attr
from ..fingerprint import pipeline as pl
from ..losses.lpips import build_lpips_params
from ..utils.device import resolve_device
from ..utils.image import make_image, store_results
from ..utils.io import make_run_dir, save_config, write_results
from .common import build_parser, config_from_args


@dataclasses.dataclass
class AttributeRun:
    run_dir: str
    bit_accs: List[float]
    losses: List[float]
    attribution_acc: float
    solve_seconds: float
    steps: int
    chains: int  # samples x restarts solved together


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(argv=None) -> AttributeRun:
    parser = build_parser("Attribution by latent inversion (PyTorch)")
    parser.add_argument("--init", choices=["lhs", "encoder"], default="lhs",
                        help="restart initialization (only lhs is ported)")
    parser.add_argument("--resume", type=str, default=None, help="not yet ported")
    parser.add_argument("--chunk_samples", type=int, default=0, help="not yet ported")
    parser.add_argument("--chunk_starts", type=int, default=0, help="not yet ported")
    args = parser.parse_args(argv)
    cfg = config_from_args(args)
    device = resolve_device(cfg.run.device)
    run_dir = save_config(
        make_run_dir(cfg.run.save_dir, cfg.attack.augmentation, cfg.fingerprint.sigma,
                     cfg.fingerprint.shift),
        cfg,
    )
    print(f"[attribute] run dir: {run_dir}")

    g_build = torch.Generator().manual_seed(cfg.run.seed)
    g_gen = torch.Generator().manual_seed(cfg.run.seed + 1)
    g_opt = torch.Generator().manual_seed(cfg.run.seed + 2)
    t0 = time.time()
    perceptual = cfg.attribution.loss == "perceptual"
    lpips_params = None
    if perceptual and (args.lpips_vgg or args.lpips_lin):
        lpips_params = build_lpips_params(g_build, device, args.lpips_vgg, args.lpips_lin)
    pipe = pl.build_pipeline(cfg.model, cfg.fingerprint, generator=g_build, device=device,
                             ckpt_path=cfg.model.ckpt, lpips_params=lpips_params,
                             want_lpips=perceptual)
    _sync(device)
    print(f"[attribute] pipeline built in {time.time() - t0:.1f}s")

    s_total = cfg.run.sample_size
    t0 = time.time()
    imgs, w0, _, true_bits, _ = pl.generate_fingerprinted(pipe, s_total, g_gen)
    targets = pl.augment(pipe, torch.clamp(imgs, -1.0, 1.0))
    _sync(device)
    print(f"[attribute] {s_total} targets generated in {time.time() - t0:.1f}s")

    t0 = time.time()
    res = attr.attribute(pipe.gen_params, pipe.lpips_params, pipe.basis, pipe.noise, targets,
                         mcfg=cfg.model, acfg=cfg.attribution, generator=g_opt)
    _sync(device)
    dt = time.time() - t0

    ev = attr.evaluate_attribution(res, true_bits)
    bit_accs = [float(a) for a in ev["bit_acc"].cpu()]
    losses = [float(v) for v in res.loss.cpu()]
    for i, (a, loss) in enumerate(zip(bit_accs, losses)):
        print(f"sample: {i}, bit acc: {a:.4f}, loss: {loss:.6f}")
    store_results(run_dir, 0, make_image(pl.synthesize(pipe, w0)), make_image(imgs))
    success = sum(a >= 1.0 for a in bit_accs)
    attribution_acc = success / len(bit_accs)
    write_results(run_dir, bit_accs, attribution_acc)

    chains = s_total * cfg.attribution.n_starts
    steps = cfg.attribution.steps
    print(f"[attribute] mean bit acc {sum(bit_accs) / len(bit_accs):.4f}, attribution acc "
          f"{attribution_acc:.4f} over {s_total} samples")
    print(f"[attribute] {dt:.2f}s solve on {device}: {steps / dt:.3f} steps/s, "
          f"{steps * chains / dt:.2f} chain-steps/s ({chains} chains)")
    return AttributeRun(run_dir=run_dir, bit_accs=bit_accs, losses=losses,
                        attribution_acc=attribution_acc, solve_seconds=dt, steps=steps,
                        chains=chains)


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
