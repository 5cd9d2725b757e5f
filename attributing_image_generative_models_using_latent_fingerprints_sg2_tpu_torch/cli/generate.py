"""Fingerprinted generation CLI.

Builds the pipeline once (weights -> PCA -> basis -> fixed noise), then
writes ``sample_size`` batches of fingerprinted images, their content-only
counterparts and the watermark visualizations in the reference's layout.

Run:
    python -m attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.cli.generate \
        --device cuda --random_init --img_size 256 --key_len 64 --shift 448 --sample_size 4

Under torchrun each batch's rows are rendered across the ranks (``--mesh_data``,
``parallel/solver.py::generate_on_mesh``) when ``--batch_size`` tiles them,
else every rank renders the whole batch; rank 0 writes the PNGs.
"""

from __future__ import annotations

import sys
import time

import torch

from ..fingerprint import pipeline as pl
from ..parallel import multihost
from ..parallel.solver import generate_on_mesh, place_pipeline, synthesize_on_mesh
from ..utils.device import resolve_device
from ..utils.image import make_image, store_results, watermark_images
from ..utils.io import make_run_dir, save_config
from .common import build_parser, config_from_args, engage_mesh


def main(argv=None) -> int:
    args = build_parser("Fingerprinted generation (PyTorch)").parse_args(argv)
    cfg = config_from_args(args)
    mesh, device = engage_mesh(cfg.run.mesh_data, cfg.run.mesh_model, resolve_device(cfg.run.device), "generate")
    writer = multihost.process_index() == 0  # rank 0 writes the PNGs
    run_dir = multihost.broadcast_one_to_all(save_config(
        make_run_dir(cfg.run.save_dir, cfg.attack.augmentation, cfg.fingerprint.sigma,
                     cfg.fingerprint.shift),
        cfg,
    ) if writer else None)
    print(f"[generate] run dir: {run_dir}")

    g_build = torch.Generator().manual_seed(cfg.run.seed)
    g_run = torch.Generator().manual_seed(cfg.run.seed + 1)
    t0 = time.time()
    pipe = pl.build_pipeline(cfg.model, cfg.fingerprint, generator=g_build, device=device,
                             ckpt_path=cfg.model.ckpt, want_lpips=False)
    print(f"[generate] pipeline built in {time.time() - t0:.1f}s")
    if mesh is not None:
        if cfg.run.batch_size % mesh.shape["data"] == 0:
            pipe = place_pipeline(mesh, pipe, shard_model=cfg.run.mesh_model > 1)
        else:
            print(f"[generate] batch {cfg.run.batch_size} does not tile the {mesh.shape['data']}-way data axis: "
                  "every rank renders the whole batch")
            mesh = None

    n_imgs = 0
    t0 = time.time()
    for _ in range(cfg.run.sample_size):
        if mesh is not None:
            imgs, w0, _, _, _ = generate_on_mesh(mesh, pipe, cfg.run.batch_size, g_run)
            w0_imgs = synthesize_on_mesh(mesh, pipe, w0)
        else:
            imgs, w0, _, _, _ = pl.generate_fingerprinted(pipe, cfg.run.batch_size, g_run)
            w0_imgs = pl.synthesize(pipe, w0)
        n_imgs += imgs.shape[0]
        if not writer:
            continue
        u8_wx, u8_w0 = make_image(imgs), make_image(w0_imgs)
        pos, neg = watermark_images(u8_wx, u8_w0)
        store_results(run_dir, n_imgs - imgs.shape[0], u8_w0, u8_wx, pos, neg)
    dt = time.time() - t0
    print(f"[generate] {n_imgs} fingerprinted images @ {cfg.model.img_size}px in {dt:.1f}s "
          f"({n_imgs / dt:.2f} imgs/s on {device})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
