"""Fingerprinted generation CLI.

Builds the pipeline once (weights -> PCA -> basis -> fixed noise), then
writes ``sample_size`` batches of fingerprinted images, their content-only
counterparts and the watermark visualizations in the reference's layout.

Run:
    python -m attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.cli.generate \
        --device cuda --random_init --img_size 256 --key_len 64 --shift 448 --sample_size 4
"""

from __future__ import annotations

import sys
import time

import torch

from ..fingerprint import pipeline as pl
from ..utils.device import resolve_device
from ..utils.image import make_image, store_results, watermark_images
from ..utils.io import make_run_dir, save_config
from .common import build_parser, config_from_args


def main(argv=None) -> int:
    args = build_parser("Fingerprinted generation (PyTorch)").parse_args(argv)
    cfg = config_from_args(args)
    device = resolve_device(cfg.run.device)
    run_dir = save_config(
        make_run_dir(cfg.run.save_dir, cfg.attack.augmentation, cfg.fingerprint.sigma,
                     cfg.fingerprint.shift),
        cfg,
    )
    print(f"[generate] run dir: {run_dir}")

    g_build = torch.Generator().manual_seed(cfg.run.seed)
    g_run = torch.Generator().manual_seed(cfg.run.seed + 1)
    t0 = time.time()
    pipe = pl.build_pipeline(cfg.model, cfg.fingerprint, generator=g_build, device=device,
                             ckpt_path=cfg.model.ckpt, want_lpips=False)
    print(f"[generate] pipeline built in {time.time() - t0:.1f}s")

    n_imgs = 0
    t0 = time.time()
    for _ in range(cfg.run.sample_size):
        imgs, w0, _, _, _ = pl.generate_fingerprinted(pipe, cfg.run.batch_size, g_run)
        u8_wx = make_image(imgs)
        u8_w0 = make_image(pl.synthesize(pipe, w0))
        pos, neg = watermark_images(u8_wx, u8_w0)
        store_results(run_dir, n_imgs, u8_w0, u8_wx, pos, neg)
        n_imgs += imgs.shape[0]
    dt = time.time() - t0
    print(f"[generate] {n_imgs} fingerprinted images @ {cfg.model.img_size}px in {dt:.1f}s "
          f"({n_imgs / dt:.2f} imgs/s on {device})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
