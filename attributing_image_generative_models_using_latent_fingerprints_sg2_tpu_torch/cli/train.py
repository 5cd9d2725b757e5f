"""StyleGAN2 training CLI.

Trains a generator on the procedural synthetic distribution
(``training/data.py``) or an image folder (``--data_dir``) and exports the
EMA generator in rosinality state-dict names as a portable ``.npz`` that
every ``--ckpt`` flag takes (``cli.generate``, ``cli.attribute``, and the
reference package's loaders), and the discriminator as ``<out>.disc.npz`` in
the flat layout (``checkpoints/flat.py``).  So the quality loop closes
without downloaded weights: train here, then ``cli.attribute --ckpt
<out.npz>`` measures key recovery against a trained generator.

Run (on the card by default; ``--device cpu`` runs the plain versions):
    python -m attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.cli.train \
        --img_size 64 --channel_max 128 --steps 3000 --batch 16 --out result/selftrain.npz

Data-parallel over N ranks: ``python -m torch.distributed.run --nproc_per_node N
-m <this module> ...`` (``--mesh_data`` 0 takes them all): every rank trains
on its rows of the global batch, gradients are averaged over the ranks
(``parallel/train.py``), and rank 0 writes the metrics, snapshots and exports.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from ..checkpoints.flat import flatten_params
from ..checkpoints.rosinality import generator_state_dict_from_params
from ..config import ModelConfig
from ..parallel import multihost
from ..parallel.train import place_train_state, shard_reals
from ..training.gan import TrainConfig, init_train_state, run_steps
from ..training.snapshot import check_meta, load_snapshot, save_snapshot
from ..utils.device import resolve_device
from .common import engage_mesh


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda (the CUDA kernels; raises without a GPU) or cpu")
    p.add_argument("--img_size", type=int, default=64)
    p.add_argument("--style_dim", type=int, default=512)
    p.add_argument("--n_mlp", type=int, default=8)
    p.add_argument("--channel_max", type=int, default=128)
    p.add_argument("--channel_multiplier", type=int, default=2)
    p.add_argument("--steps", type=int, default=3000)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--lr", type=float, default=0.002)
    p.add_argument("--r1", type=float, default=10.0)
    p.add_argument("--d_reg_every", type=int, default=16)
    p.add_argument("--mixing", type=float, default=0.9)
    p.add_argument("--ema_decay", type=float, default=0.999)
    p.add_argument("--data_sharp", action="store_true",
                   help="train on the sharp-feature synthetic variant (rectangles + stripes)")
    p.add_argument("--data_dim", type=int, default=0,
                   help="cap the synthetic data manifold's intrinsic dimension (0 = the full "
                   "35-factor draw)")
    p.add_argument("--data_dir", type=str, default=None,
                   help="train on the images under this folder (recursive; PNG/JPEG by the native "
                   "decoder when built, else PIL), center-cropped and area-resampled to --img_size")
    p.add_argument("--prefetch", type=int, default=4, help="decode lookahead (batches) for --data_dir")
    p.add_argument("--decode_threads", type=int, default=0,
                   help="native decode threads for --data_dir (0 = all cores)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mesh_data", type=int, default=0,
                   help="data-parallel ranks (0 = every rank of the torchrun job; 1 = none): each rank "
                   "trains on its rows of the global batch, gradients averaged; the global batch's "
                   "semantics, so --snapshot / --resume compose unchanged")
    p.add_argument("--chunk", type=int, default=100,
                   help="steps between metric rows written, snapshots and log lines")
    p.add_argument("--log_every", type=int, default=1, help="log every N chunks")
    p.add_argument("--out", type=str, default="result/selftrain.npz",
                   help="EMA generator export path (.npz, rosinality names)")
    p.add_argument("--snapshot", type=str, default=None,
                   help="training snapshot path (.npz): the whole state (G, D, EMA, both Adam "
                   "states, step), written atomically at chunk boundaries; with --resume a "
                   "preempted run continues")
    p.add_argument("--snapshot_every", type=int, default=1, help="chunks between snapshot writes")
    p.add_argument("--resume", action="store_true",
                   help="resume from --snapshot if it exists (refuses on a config mismatch)")
    p.add_argument("--metrics_out", type=str, default=None,
                   help="append one jsonl row of d_loss/g_loss/r1 per step (+ the chunk's steps/s); "
                   "appends across --resume")
    p.add_argument("--compile_cache", type=str, default=None,
                   help="accepted for the reference CLI's flag surface and ignored: nothing is compiled")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    mesh, device = engage_mesh(args.mesh_data, 1, resolve_device(args.device), "train")
    if mesh is not None and args.batch % mesh.shape["data"]:
        print(f"[train] batch {args.batch} does not tile the {mesh.shape['data']}-way data axis: every rank "
              "trains on the whole batch")
        mesh = None
    writer = multihost.process_index() == 0  # rank 0 writes metrics, snapshots and exports
    mcfg = ModelConfig(model="sg2", img_size=args.img_size, style_dim=args.style_dim, n_mlp=args.n_mlp,
                       channel_max=args.channel_max, channel_multiplier=args.channel_multiplier, ckpt=None)
    tcfg = TrainConfig(batch=args.batch, lr=args.lr, r1=args.r1, d_reg_every=args.d_reg_every,
                       mixing=args.mixing, ema_decay=args.ema_decay, data_sharp=args.data_sharp,
                       data_latent_dim=args.data_dim)

    t0 = time.time()
    state = init_train_state(mcfg, tcfg, torch.Generator().manual_seed(args.seed), device)
    print(f"[train] state initialized in {time.time() - t0:.1f}s ({args.img_size}px, "
          f"channel_max={args.channel_max}, {device})")

    # run-defining meta: resuming across any of these would change the optimization
    run_meta = {
        "img_size": args.img_size, "style_dim": args.style_dim, "n_mlp": args.n_mlp,
        "channel_max": args.channel_max, "channel_multiplier": args.channel_multiplier,
        "batch": args.batch, "lr": args.lr, "r1": args.r1, "d_reg_every": args.d_reg_every,
        "mixing": args.mixing, "ema_decay": args.ema_decay, "data_sharp": args.data_sharp,
        "data_dim": args.data_dim, "data_dir": args.data_dir, "seed": args.seed,
    }
    start = 0
    if args.snapshot and args.resume and os.path.exists(args.snapshot):
        state, meta = load_snapshot(args.snapshot, state)
        check_meta(meta, run_meta)
        start = int(meta["step"])
        print(f"[train] resumed from {args.snapshot} at step {start}")
    if mesh is not None:
        state = place_train_state(mesh, state)

    data_iter = None
    if args.data_dir is not None:
        from ..training.folder import ImageFolder

        dataset = ImageFolder(args.data_dir, args.img_size)
        print(f"[train] folder data: {len(dataset)} images under {args.data_dir} "
              f"(native decode: {'yes' if dataset.native_decode else 'no (PIL)'})")
        data_iter = dataset.batches(args.seed, args.batch, max(0, args.steps - start),
                                    prefetch=args.prefetch, n_threads=args.decode_threads, start=start)

    chunk = max(1, args.chunk)
    n_chunks = max(0, args.steps - start + chunk - 1) // chunk
    t0 = time.time()
    done = start
    for ci in range(n_chunks):
        length = min(chunk, args.steps - done)
        t_chunk = time.time()
        reals = None
        if data_iter is not None:
            reals = torch.from_numpy(np.stack([next(data_iter) for _ in range(length)]))
            reals = list(reals if mesh is None else shard_reals(mesh, reals))
        rows = run_steps(state, args.seed, length, mcfg, tcfg, reals, mesh=mesh)  # ends in a host sync
        chunk_dt = time.time() - t_chunk
        done += length
        if not writer:
            continue
        if args.metrics_out:
            with open(args.metrics_out, "a") as f:
                for j in range(length):
                    f.write(json.dumps({"step": done - length + j + 1,
                                        **{k: float(v[j]) for k, v in rows.items()},
                                        "chunk_steps_per_s": round(length / max(chunk_dt, 1e-9), 2)}) + "\n")
        if args.snapshot and (ci % max(1, args.snapshot_every) == 0 or ci == n_chunks - 1):
            save_snapshot(args.snapshot, state, {**run_meta, "step": done})
        if ci % max(1, args.log_every) == 0 or ci == n_chunks - 1:
            dt = time.time() - t0
            print(f"[train] step {done}/{args.steps}  d {rows['d_loss'][-1]:.3f}  g {rows['g_loss'][-1]:.3f}  "
                  f"r1 {rows['r1'][-1]:.3f}  ({(done - start) / dt:.1f} steps/s)", flush=True)
    dt = time.time() - t0
    print(f"[train] {done - start} steps in {dt:.1f}s ({(done - start) / max(dt, 1e-9):.1f} steps/s)")

    if args.out and writer:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        sd = generator_state_dict_from_params(state.g_ema)
        np.savez(args.out, **sd)
        print(f"[train] EMA generator exported to {args.out} ({len(sd)} tensors, rosinality names; "
              f"use --ckpt {args.out})")
        dpath = args.out + ".disc.npz"
        dsd = flatten_params(state.d_params)
        np.savez(dpath, **dsd)
        print(f"[train] discriminator exported to {dpath} ({len(dsd)} tensors, flat layout)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
