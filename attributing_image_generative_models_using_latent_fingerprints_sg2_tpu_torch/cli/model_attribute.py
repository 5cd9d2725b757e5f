"""Model-level attribution CLI: WHICH registered generator made these images?

Registers N generators (StyleGAN2: rosinality ``.pt`` or ``.npz``; BigGAN
with ``--model biggan``: ``pytorch_pretrained_biggan`` state dicts), solves
the targets under every model and reports the minimum-loss decision, with an
open-set threshold given or calibrated in the run from in-distribution solves.

Two target modes::

    # images from disk (PNG/JPEG through PIL, or .npy [H, W, 3] float [-1, 1] or uint8)
    python -m attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.cli.model_attribute \\
        --models a=ck_a.npz b=ck_b.npz --images img0.png img1.npy --loss mse --calibrate 4

    # self-test: --sample_size targets generated round-robin by the registered models
    python -m attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.cli.model_attribute \\
        --random_init --img_size 256 --key_len 64 --shift 448 --sample_size 2 --n 4 --steps 20 \\
        --calibrate 1 --out record.json

Every solver flag and the fingerprint geometry (--key_len, --shift, --sigma)
is shared by the registry: model attribution is defined only when every
model embeds with one scheme.  With --attack_aware the calibration solves
and the main solves use the configured attack strengths.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import Config
from ..fingerprint import attribute as attr
from ..fingerprint import pipeline as pl
from ..fingerprint.model_attribution import attribute_model, calibrate_open_set_threshold
from ..utils.device import resolve_device
from ..utils.image import load_image, to_training_range
from ..utils.lhs import fold_in
from .common import build_parser, config_from_args, resolve_lpips


def _parse_models(specs: Sequence[str]) -> List[Tuple[str, str]]:
    out = []
    for spec in specs:
        name, sep, path = spec.partition("=")
        if not sep or not name or not path:
            raise SystemExit(f"--models entries must be NAME=PATH, got {spec!r}")
        if not os.path.exists(path):
            raise SystemExit(f"model checkpoint not found: {path!r}")
        out.append((name, path))
    if len({n for n, _ in out}) != len(out):
        raise SystemExit("--models names must be unique")
    return out


def load_targets(paths: Sequence[str], img_size: int) -> np.ndarray:
    """PNG/JPEG (PIL, center crop + area resample) or .npy -> [N, H, W, 3] float32 in [-1, 1]."""
    rows = []
    for p in paths:
        if p.endswith(".npy"):
            arr = np.load(p)
            arr = to_training_range(arr) if arr.dtype == np.uint8 else np.asarray(arr, np.float32)
            if arr.shape != (img_size, img_size, 3):
                raise SystemExit(f"{p}: expected ({img_size},{img_size},3), got {arr.shape}")
            rows.append(arr)
        else:
            rows.append(to_training_range(load_image(p, img_size)))
    return np.stack(rows)


def calibrate(pipes: Dict[str, pl.Pipeline], cfg: Config, n: int, generator: torch.Generator, clip: bool,
              percentile: float = 99.0, slack: float = 2.0) -> float:
    """Open-set threshold from ``n`` fingerprinted images of each registered
    model solved under that model, each with its own family arguments and the
    configured attack strengths."""
    acfg = cfg.attribution
    losses = []
    for i, p in enumerate(pipes.values()):
        imgs, *_ = pl.generate_fingerprinted(p, n, fold_in(generator, 3000 + i))
        res = attr.attribute(p.gen_params, p.lpips_params, p.basis, p.noise,
                             torch.clamp(imgs, -1.0, 1.0) if clip else imgs, mcfg=p.mcfg, acfg=acfg,
                             generator=fold_in(generator, 4000 + i),
                             attack_cfg=cfg.attack if acfg.solver_attack != "None" else None,
                             dtype=cfg.run.dtype, remat=cfg.run.remat, **pl.solver_kwargs(p))
        losses.append(res.loss.cpu().numpy())
    return calibrate_open_set_threshold(np.concatenate(losses), percentile=percentile, slack=slack)


def run(argv=None) -> dict:
    """Parse the flags, build the registry, solve, print the decisions and
    return the record (written to ``--out`` as JSON when given)."""
    parser = build_parser("Model-level attribution: which registered generator made this? (PyTorch)")
    parser.add_argument("--models", nargs="+", default=[], metavar="NAME=PATH",
                        help="registry of fingerprinted generators (all share the CLI's architecture flags)")
    parser.add_argument("--images", nargs="*", default=[],
                        help="target images (PNG/JPEG/.npy); none = self-test mode: --sample_size targets "
                        "generated round-robin by the registry, decisions scored")
    parser.add_argument("--open_set_threshold", type=float, default=float("inf"),
                        help="a best loss above this attributes to NO registered model (default inf: closed "
                        "set); --calibrate overrides it")
    parser.add_argument("--calibrate", type=int, default=0,
                        help="calibrate the open-set threshold from this many in-distribution solves per "
                        "registered model (0 = off)")
    parser.add_argument("--calibrate_percentile", type=float, default=99.0)
    parser.add_argument("--calibrate_slack", type=float, default=2.0)
    parser.add_argument("--out", type=str, default=None,
                        help="write the decision record (loss matrix, margins, decisions) as JSON here")
    parser.add_argument("--no_clip_targets", action="store_true",
                        help="skip the [-1, 1] clip of generated targets (random-init test generators leave "
                        "that range, and clipping pushes their images off the manifold)")
    args = parser.parse_args(argv)

    models: List[Tuple[str, Optional[str]]] = list(_parse_models(args.models))
    if models:
        args.random_init = True  # the weights come from --models, not --ckpt
    elif args.random_init:
        models = [("random_a", None), ("random_b", None)]
    else:
        raise SystemExit("pass --models NAME=PATH [NAME=PATH ...] (or --random_init for a smoke registry)")
    cfg = config_from_args(args)
    device = resolve_device(cfg.run.device)

    # one PCA per model, LPIPS built once and shared
    t0 = time.time()
    attacked = cfg.attack.augmentation != "None"
    want_lpips, shared_lpips = resolve_lpips(args, cfg)
    pipes: Dict[str, pl.Pipeline] = {}
    for i, (name, path) in enumerate(models):
        pipe = pl.build_pipeline(cfg.model, cfg.fingerprint, generator=fold_in(cfg.run.seed, i), device=device,
                                 attack_cfg=cfg.attack if attacked else None, ckpt_path=path,
                                 lpips_params=shared_lpips, want_lpips=want_lpips and shared_lpips is None)
        shared_lpips = pipe.lpips_params
        pipes[name] = pipe
    names = list(pipes)
    print(f"[model_attribute] {len(pipes)} models registered in {time.time() - t0:.1f}s: {', '.join(names)}")

    root = torch.Generator().manual_seed(cfg.run.seed)
    clip = not args.no_clip_targets
    provenance = None
    if args.images:
        targets = torch.from_numpy(load_targets(args.images, cfg.model.img_size))
        labels = list(args.images)
    else:
        per = max(1, cfg.run.sample_size // len(pipes))
        rows, provenance, labels = [], [], []
        for i, name in enumerate(names):
            imgs, *_ = pl.generate_fingerprinted(pipes[name], per, fold_in(root, 1000 + i))
            if clip:
                imgs = torch.clamp(imgs, -1.0, 1.0)
            rows.append(pl.augment(pipes[name], imgs, fold_in(root, 2000 + i)))
            provenance += [i] * per
            labels += [f"{name}#{j}" for j in range(per)]
        targets = torch.cat(rows)
        provenance = np.asarray(provenance)
        print(f"[model_attribute] self-test: {targets.shape[0]} targets ({per} per model), "
              f"attack={cfg.attack.augmentation}")

    tau = args.open_set_threshold
    if args.calibrate > 0:
        tau = calibrate(pipes, cfg, args.calibrate, root, clip, args.calibrate_percentile, args.calibrate_slack)
        print(f"[model_attribute] calibrated open-set threshold: {tau:.3e} (p{args.calibrate_percentile:g} x "
              f"{args.calibrate_slack:g} over {len(pipes) * args.calibrate} in-dist solves)")

    acfg = cfg.attribution
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.time()
    res = attribute_model(pipes, targets.to(device), fold_in(root, 5000), acfg, open_set_threshold=tau,
                          attack_cfg=cfg.attack if acfg.solver_attack != "None" else None,
                          dtype=cfg.run.dtype, remat=cfg.run.remat)
    dt = time.time() - t0
    n = targets.shape[0]
    print(f"[model_attribute] solved {n} targets x {len(pipes)} models in {dt:.1f}s")

    rows = []
    for s in range(n):
        chosen = res.chosen(s)
        rows.append({"target": labels[s], "model": chosen, "best_loss": float(res.losses[res.best_model[s], s]),
                     "margin": float(res.margin[s]), "decided": bool(res.decided[s])})
        print(f"  {labels[s]}: -> {chosen or 'REJECTED (open set)'} (loss {rows[-1]['best_loss']:.3e}, "
              f"margin x{rows[-1]['margin']:.1f})")
    record = {"models": names, "open_set_threshold": tau if np.isfinite(tau) else None,
              "loss_matrix": res.losses.tolist(), "decisions": rows}
    if provenance is not None:
        correct = (res.best_model == provenance) & res.decided
        record["self_test_accuracy"] = float(correct.mean())
        print(f"[model_attribute] self-test accuracy: {record['self_test_accuracy']:.4f} ({int(correct.sum())}/{n})")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
        print(f"[model_attribute] record written to {args.out}")
    return record


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
