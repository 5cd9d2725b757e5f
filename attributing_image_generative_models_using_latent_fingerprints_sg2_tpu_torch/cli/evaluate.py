"""Evaluation CLI: the capacity-quality sweep, with FID where asked.

Counterpart of the reference package's ``cli/evaluate.py``: a key_len x
sigma x shift grid measuring bit accuracy, exact-match accuracy, the
recovered content latent's cosine, and watermark visibility (LPIPS and MSE
between content-only and fingerprinted images, FID between the two
populations with ``--with_fid``), written as JSON to ``--out``.

Run (on the card by default; ``--device cpu`` runs the plain versions):
    python -m attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.cli.evaluate \
        --random_init --img_size 256 --key_lens 64 --sigmas 1.0 --samples 2 --steps 20 --n 4 --with_fid
"""

from __future__ import annotations

import os
import sys

from ..eval.sweep import run_sweep, sweep_to_json
from ..utils.device import resolve_device
from .common import build_parser, config_from_args, custom_lpips


def main(argv=None) -> int:
    parser = build_parser("fingerprint capacity-quality sweep (PyTorch)")
    parser.add_argument("--key_lens", type=str, default="32,64,128")
    parser.add_argument("--sigmas", type=str, default="1.0")
    parser.add_argument("--shifts", type=str, default="", help="comma list; empty = D - key_len per point")
    parser.add_argument("--samples", type=int, default=4)
    parser.add_argument("--with_fid", action="store_true")
    parser.add_argument("--out", type=str, default="sweep.json")
    args = parser.parse_args(argv)
    cfg = config_from_args(args)
    device = resolve_device(cfg.run.device)

    pts = run_sweep(
        cfg.run.seed,
        cfg.model,
        key_lens=tuple(int(v) for v in args.key_lens.split(",") if v),
        sigmas=tuple(float(v) for v in args.sigmas.split(",") if v),
        shifts=tuple(int(v) for v in args.shifts.split(",") if v) or None,
        samples=args.samples,
        acfg=cfg.attribution,
        ckpt_path=cfg.model.ckpt,
        with_fid=args.with_fid,
        dtype=cfg.run.dtype,
        # the visibility LPIPS (and, perceptual, the solve's) of the LPIPS flags
        lpips_params=custom_lpips(args, device),
        # a random generator's images leave [-1, 1]: clipping them would push the
        # targets off its manifold; real checkpoints are measured clipped, as deployed
        clip_targets=not args.random_init,
        device=device,
    )
    js = sweep_to_json(pts)
    with open(args.out, "w") as f:
        f.write(js)
    print(js)
    print(f"[evaluate] wrote {os.path.abspath(args.out)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
