"""Serving CLI: a long-lived fingerprint generation / attribution service.

Builds the pipeline once, optionally trains the encoder that seeds the
served solves (``--init encoder``; on the ``--augmentation`` channel when
one is set), warms every batch bucket, then serves HTTP/JSON with request
micro-batching (``serving/``).

Run:
    python -m attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.cli.serve \
        --random_init --img_size 256 --key_len 64 --shift 448 --steps 500 --n 8 \
        --init encoder --registry registry.json --port 8787

    curl -s localhost:8787/healthz
    curl -s -X POST localhost:8787/v1/generate -d '{"seed": 7}'
    curl -s localhost:8787/v1/stats

Under torchrun (``python -m torch.distributed.run --nproc_per_node N -m
<this module> ...``) each device batch is sharded over the ranks
(``--mesh_data``, ``--mesh_model``): rank 0 serves HTTP and runs the queue,
the other ranks follow its batches.  Buckets that do not tile the "data"
axis are dropped with a note; with none left, rank 0 serves on one device.
"""

from __future__ import annotations

import sys
import time
from http.server import ThreadingHTTPServer
from typing import Optional, Tuple

import torch

from ..fingerprint import encoder as enc_mod
from ..fingerprint import pipeline as pl
from ..fingerprint.keys import KeyRegistry
from ..parallel import multihost
from ..serving import InferenceEngine, ServeConfig, make_server
from ..utils.device import resolve_device
from .common import build_parser, config_from_args, engage_mesh, resolve_lpips


def build_server(argv=None) -> Tuple[InferenceEngine, Optional[ThreadingHTTPServer]]:
    """Parse the flags, build and warm the engine (worker started), and bind
    the HTTP server without serving; the caller serves and stops both.  On a
    mesh rank other than 0 the engine is built, not started, and the server
    is None: the caller runs ``engine.follow()`` (a rank outside any mesh
    returns at once)."""
    parser = build_parser("Fingerprint serving over HTTP/JSON (PyTorch)")
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8787, help="0 binds a free port")
    parser.add_argument("--buckets", type=str, default="1,4,8",
                        help="comma-separated static batch buckets (ascending)")
    parser.add_argument("--max_wait_ms", type=float, default=5.0,
                        help="batch coalescing window after the first queued request")
    parser.add_argument("--no_attribute", action="store_true",
                        help="serve generation only (no solver, no LPIPS, no encoder)")
    parser.add_argument("--registry", type=str, default=None,
                        help="KeyRegistry JSON (cli.keys issue) enabling /v1/identify and generate-for-user")
    parser.add_argument("--init", choices=["lhs", "encoder"], default="lhs",
                        help="restart init of served solves: blind centered LHS, or around the "
                        "prediction of an encoder trained at startup on frozen-generator pairs")
    parser.add_argument("--encoder_steps", type=int, default=1500,
                        help="--init encoder: training steps")
    parser.add_argument("--encoder_jitter", type=float, default=0.25,
                        help="--init encoder: LHS cloud radius around the prediction, in units of sigma_rest")
    args = parser.parse_args(argv)
    cfg = config_from_args(args)
    mesh, device = engage_mesh(cfg.run.mesh_data, cfg.run.mesh_model, resolve_device(cfg.run.device), "serve")
    buckets = tuple(int(b) for b in args.buckets.split(",") if b)
    if mesh is not None:
        data = mesh.shape["data"]
        tiling = tuple(b for b in buckets if b % data == 0)
        if not tiling:
            print(f"[serve] no bucket in {buckets} tiles the {data}-way data axis; serving on one device (pass "
                  "multiples of it in --buckets to engage the mesh)")
            mesh = None
        elif tiling != buckets:
            print(f"[serve] buckets {buckets} -> {tiling} (multiples of the {data}-way data axis)")
            buckets = tiling

    g_build = torch.Generator().manual_seed(cfg.run.seed)
    attacked = cfg.attack.augmentation != "None"
    want_lpips, lpips_params = resolve_lpips(args, cfg, want=not args.no_attribute)
    pipe = pl.build_pipeline(cfg.model, cfg.fingerprint, generator=g_build, device=device,
                             attack_cfg=cfg.attack if attacked else None, ckpt_path=cfg.model.ckpt,
                             lpips_params=lpips_params, want_lpips=want_lpips)
    registry = None
    if args.registry:
        registry = KeyRegistry.load(args.registry)
        print(f"[serve] registry: {len(registry)} users, min_distance {registry.min_distance}")
    encoder_params = None
    if args.init == "encoder" and not args.no_attribute:
        t0 = time.time()
        # on the channel the served images went through, as cli.attribute trains it
        encoder_params, curve, _ = enc_mod.train_for_init(
            pipe.gen_params, pipe.basis, pipe.noise, mcfg=cfg.model, seed=cfg.run.seed,
            steps=args.encoder_steps, jitter=args.encoder_jitter, attack_cfg=cfg.attack if attacked else None)
        final = f"{float(curve[-1]):.4f}" if len(curve) else "n/a"
        print(f"[serve] encoder trained in {time.time() - t0:.1f}s ({args.encoder_steps} steps, "
              f"final loss {final})")
    engine = InferenceEngine(pipe, acfg=None if args.no_attribute else cfg.attribution,
                             cfg=ServeConfig(buckets=buckets, max_wait_ms=args.max_wait_ms), seed=cfg.run.seed,
                             registry=registry, encoder_params=encoder_params,
                             encoder_jitter=args.encoder_jitter, attack_cfg=cfg.attack, mesh=mesh,
                             shard_model=cfg.run.mesh_model > 1)
    if multihost.process_index() != 0:
        return engine, None
    print(f"[serve] warming buckets {buckets} on {device} ...", flush=True)
    t0 = time.time()
    engine.start()
    print(f"[serve] warm in {time.time() - t0:.1f}s")
    try:
        return engine, make_server(engine, args.host, args.port)
    except OSError:
        engine.stop()
        raise


def main(argv=None) -> int:
    engine, server = build_server(argv)
    if server is None:
        if engine.mesh is not None:
            engine.follow()
        return 0
    host, port = server.server_address[:2]
    print(f"[serve] listening on {host}:{port}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        print("[serve] shutting down")
    finally:
        server.server_close()
        engine.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
