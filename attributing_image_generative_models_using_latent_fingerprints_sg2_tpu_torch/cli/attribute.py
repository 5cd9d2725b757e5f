"""Attribution CLI: generate fingerprinted targets with known keys,
optionally attack them, invert them (every sample x every Latin-Hypercube
restart of a chunk as one batch), and report per-sample bit accuracy and
exact-match attribution accuracy in ``result.txt``, with the original and
watermarked PNGs beside it.  With ``--init encoder`` an encoder trained on
the attack channel first predicts each target's (alpha, key), and every
restart starts around that prediction.  After every sample chunk the run's
state is saved (``attribution_state.json`` + ``attribution_arrays.npz``, and
the init scheme in ``init_scheme.json``), and ``--resume RUN_DIR`` finishes
an interrupted run from it.

Run:
    python -m attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.cli.attribute \
        --device cuda --random_init --img_size 256 --key_len 64 --shift 448 \
        --loss perceptual --sample_size 2 --n 4 --steps 20 \
        --augmentation Jpeg --attack_aware --init encoder --encoder_steps 100 \
        --prune_starts 2 --polish_sweeps 1 --chunk_samples 1

``--dtype bfloat16`` runs synthesis and LPIPS in bfloat16 (the bf16 kernels)
with the optimizer state and the loss in float32; ``--remat``
gradient-checkpoints the synthesis blocks (the same solve in less memory:
more restart chains fit in one chunk).  A resumed run takes the dtype and
``--remat`` saved in its run directory.

Under torchrun (``python -m torch.distributed.run --nproc_per_node N -m
<this module> ...``) each sample chunk is solved with its samples sharded
over the ranks (``--mesh_data``, ``parallel/solver.py``); rank 0 writes the
run's files.  ``--profile`` prints the phase report at the end and writes a
``torch.profiler`` Chrome trace of the first solve chunk to
``<run_dir>/trace/``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
import time
from typing import List

import numpy as np
import torch

from ..checkpoints.state import AttributionRunState, load_init_scheme, load_state, save_init_scheme, save_state
from ..config import Config
from ..fingerprint import attribute as attr
from ..fingerprint import encoder as enc_mod
from ..fingerprint import pipeline as pl
from ..parallel import multihost
from ..parallel.mesh import replicate
from ..parallel.solver import attribute_on_mesh
from ..utils import profiling as prof
from ..utils.device import resolve_device
from ..utils.image import make_image, store_results
from ..utils.io import make_run_dir, save_config, write_results
from ..utils.lhs import fold_in
from .common import build_parser, config_from_args, engage_mesh, resolve_lpips


@dataclasses.dataclass
class AttributeRun:
    run_dir: str
    bit_accs: List[float]  # every sample of the run, resumed ones included
    losses: List[float]  # samples solved by this process only
    attribution_acc: float
    solve_seconds: float
    steps: int
    chains: int  # samples x restarts started together in one sample chunk
    chain_steps: int  # chain-steps this run solved (pruning counted; on a mesh, all ranks together)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(argv=None) -> AttributeRun:
    parser = build_parser("Attribution by latent inversion (PyTorch)")
    parser.add_argument("--init", choices=["lhs", "encoder"], default="lhs",
                        help="restart initialization: blind centered LHS, or around the prediction of "
                        "an encoder trained at startup on frozen-generator pairs (fingerprint/encoder.py)")
    parser.add_argument("--encoder_steps", type=int, default=1500,
                        help="--init encoder: training steps")
    parser.add_argument("--encoder_batch", type=int, default=0,
                        help="--init encoder: rendered images per training step; 0 = "
                        "encoder.auto_batch (64 through 128px, 16 at 256px)")
    parser.add_argument("--encoder_jitter", type=float, default=0.25,
                        help="--init encoder: LHS cloud radius around the prediction, in units of sigma_rest")
    parser.add_argument("--chunk_samples", type=int, default=0,
                        help="attribute in chunks of this many samples (0 = all at once); "
                        "bounds peak memory at large sample_size")
    parser.add_argument("--chunk_starts", type=int, default=0,
                        help="split the restarts into chunks of this many (0 = all at once); "
                        "bounds peak memory at large --n")
    parser.add_argument("--resume", type=str, default=None,
                        help="resume an interrupted run from its run dir (its saved config, seed "
                        "and init scheme are used; of the flags only --device, --chunk_* and the "
                        "LPIPS weight paths are honored)")
    parser.add_argument("--profile", action="store_true",
                        help="print the per-phase wall-clock report at the end, and write a torch.profiler "
                        "Chrome trace of the first solve chunk to <run_dir>/trace/")
    args = parser.parse_args(argv)

    prior_arrays = {}
    scheme = {"init": args.init, "encoder_steps": args.encoder_steps, "encoder_batch": args.encoder_batch,
              "encoder_jitter": args.encoder_jitter}
    if args.resume:
        run_dir = args.resume
        state, prior_arrays = load_state(run_dir)
        saved_scheme = load_init_scheme(run_dir)
        if saved_scheme is None:
            print(f"[attribute] no saved init scheme in {run_dir}; using --init {args.init}")
        scheme = saved_scheme or scheme
        if state is not None and state.config:
            # The saved config is authoritative: targets and true keys are regenerated
            # from (config, seed), so solving the tail under other flags would mix two
            # runs in one result.txt.  Where the run executes is not part of what it computes.
            cfg = Config.from_dict(state.config)
            cfg = dataclasses.replace(cfg, run=dataclasses.replace(
                cfg.run, device=args.device, mesh_data=args.mesh_data, mesh_model=args.mesh_model))
            print(f"[attribute] resuming at sample {state.next_sample} from {run_dir} with its "
                  f"saved config (seed {cfg.run.seed}); other CLI flags are ignored")
        else:
            cfg = config_from_args(args)
            if state is None:
                print(f"[attribute] no state in {run_dir}; starting fresh there")
                state = AttributionRunState(seed=cfg.run.seed, config=cfg.to_dict())
            else:
                print(f"[attribute] resuming at sample {state.next_sample} from {run_dir} "
                      "(no saved config; using CLI flags)")
    else:
        cfg = config_from_args(args)
        run_dir = None
        state = AttributionRunState(seed=cfg.run.seed, config=cfg.to_dict())
    mesh, device = engage_mesh(cfg.run.mesh_data, cfg.run.mesh_model, resolve_device(cfg.run.device), "attribute")
    writer = multihost.process_index() == 0  # rank 0 writes the run's files
    if run_dir is None:
        run_dir = multihost.broadcast_one_to_all(save_config(
            make_run_dir(cfg.run.save_dir, cfg.attack.augmentation, cfg.fingerprint.sigma,
                         cfg.fingerprint.shift),
            cfg,
        ) if writer else None)
    if writer:
        save_init_scheme(run_dir, scheme)
    print(f"[attribute] run dir: {run_dir}")

    # one stream per purpose, each a function of the seed alone
    g_build = torch.Generator().manual_seed(state.seed)
    g_gen = torch.Generator().manual_seed(state.seed + 1)
    g_atk = torch.Generator().manual_seed(state.seed + 3)
    opt_seed = state.seed + 2
    t0 = time.time()
    want_lpips, lpips_params = resolve_lpips(args, cfg)
    attacked = cfg.attack.augmentation != "None"
    with prof.phase("build_pipeline"):
        pipe = pl.build_pipeline(cfg.model, cfg.fingerprint, generator=g_build, device=device,
                                 attack_cfg=cfg.attack if attacked else None,
                                 ckpt_path=cfg.model.ckpt, lpips_params=lpips_params,
                                 want_lpips=want_lpips)
        _sync(device)
    print(f"[attribute] pipeline built in {time.time() - t0:.1f}s")

    s_total = cfg.run.sample_size
    t0 = time.time()
    with prof.device_phase("generate_targets") as box:
        imgs, w0, _, true_bits, _ = pl.generate_fingerprinted(pipe, s_total, g_gen)
        targets = pl.augment(pipe, torch.clamp(imgs, -1.0, 1.0), g_atk)
        box.append(targets)
    print(f"[attribute] {s_total} targets generated in {time.time() - t0:.1f}s")

    acfg = cfg.attribution
    alpha_init_all = key_init_all = None
    if scheme["init"] == "encoder":
        t0 = time.time()
        with prof.phase("train_encoder"):
            enc_params, enc_curve, ecfg = enc_mod.train_for_init(
                pipe.gen_params, pipe.basis, pipe.noise, mcfg=cfg.model, seed=state.seed,
                steps=scheme["encoder_steps"], jitter=scheme["encoder_jitter"], batch=scheme["encoder_batch"],
                attack_cfg=cfg.attack if attacked else None)
            alpha_init_all, key_init_all = enc_mod.encoder_solve_init(
                enc_params, pipe.basis, targets, acfg.n_starts, fold_in(state.seed, 8), jitter=ecfg.jitter)
            if mesh is not None:  # each rank trained its own encoder: all solve from rank 0's starts
                alpha_init_all, key_init_all = replicate(mesh, [alpha_init_all.clone(), key_init_all.clone()])
            enc_acc = float(enc_mod.encoder_bit_accuracy(enc_params, targets, true_bits).mean())
        final = f"{float(enc_curve[-1]):.4f}" if len(enc_curve) else "n/a"
        print(f"[attribute] encoder trained in {time.time() - t0:.1f}s ({ecfg.steps} steps, batch {ecfg.batch}, "
              f"final loss {final}); zero-step decode bit acc {enc_acc:.4f}")
    chunk = args.chunk_samples or s_total
    bit_accs = list(state.bit_accs)
    success = state.success
    first_chunk = state.next_sample
    # per-sample arrays accumulate over chunks, and over resumes when the prior
    # checkpoint's rows line up with the progress cursor
    rec_bits: list = []
    losses_all: list = []
    if (first_chunk > 0 and prior_arrays.get("recovered_bits") is not None
            and prior_arrays["recovered_bits"].shape[0] == first_chunk):
        rec_bits.append(prior_arrays["recovered_bits"])
        losses_all.append(prior_arrays["losses_all"])
    elif first_chunk > 0:
        print("[attribute] prior per-sample arrays missing or misaligned; "
              "attribution_arrays.npz will cover resumed samples only")
    losses: List[float] = []
    dt = 0.0  # the solves alone: PNGs and the state are written between them
    for c0 in range(first_chunk, s_total, chunk):
        c1 = min(c0 + chunk, s_total)
        solve_fn = None
        if mesh is not None and (c1 - c0) % mesh.shape["data"] == 0:
            def solve_fn(tgt, generator, **kw):
                # each rank solves its rows of the chunk (and of every restart chunk)
                return attribute_on_mesh(mesh, pipe.gen_params, pipe.lpips_params, pipe.basis, pipe.noise, tgt,
                                         mcfg=cfg.model, acfg=acfg, generator=generator,
                                         shard_model=cfg.run.mesh_model > 1, **kw)

        # the trace stands outside the device phase, so that the phase's fence ends the traced work
        trace_ctx = (prof.trace(os.path.join(run_dir, "trace"), device) if args.profile and c0 == first_chunk
                     else contextlib.nullcontext())
        with trace_ctx:
            _sync(device)
            t0 = time.time()
            with prof.device_phase("solve_chunk") as box:
                # the chunk that starts at sample c0 draws the same restarts in every run of this
                # config and seed, whichever chunks ran before it in this process
                res = attr.attribute_chunked(
                    pipe.gen_params, pipe.lpips_params, pipe.basis, pipe.noise, targets[c0:c1],
                    mcfg=cfg.model, acfg=acfg, generator=fold_in(opt_seed, c0),
                    chunk_starts=args.chunk_starts, solve_fn=solve_fn, dtype=cfg.run.dtype, remat=cfg.run.remat,
                    attack_cfg=cfg.attack if acfg.solver_attack != "None" else None,
                    alpha_init=None if alpha_init_all is None else alpha_init_all[c0:c1],
                    key_init=None if key_init_all is None else key_init_all[c0:c1], **pl.solver_kwargs(pipe))
                box.append(res.loss)
            dt += time.time() - t0  # the solve alone: the trace starts before and is written after
        ev = attr.evaluate_attribution(res, true_bits[c0:c1])
        for i, (a, loss) in enumerate(zip(ev["bit_acc"].cpu().tolist(), res.loss.cpu().tolist())):
            bit_accs.append(float(a))
            losses.append(float(loss))
            success += a >= 1.0
            print(f"sample: {c0 + i}, bit acc: {a:.4f}, loss: {loss:.6f}")
        state.next_sample, state.bit_accs, state.success = c1, bit_accs, int(success)
        rec_bits.append(res.key_bits.cpu().numpy())
        losses_all.append(res.losses_all.cpu().numpy())
        if not writer:
            continue
        store_results(run_dir, c0, make_image(pl.synthesize(pipe, w0[c0:c1])), make_image(imgs[c0:c1]))
        write_results(run_dir, bit_accs, success / len(bit_accs))
        rb = np.concatenate(rec_bits, axis=0)
        # rows of recovered_bits / losses_all align with true_bits[first_sample:]
        # (first_sample > 0 only when a resume could not recover the prior chunks' arrays)
        save_state(run_dir, state, arrays={
            "true_bits": true_bits[:c1].cpu().numpy(), "recovered_bits": rb,
            "losses_all": np.concatenate(losses_all, axis=0),
            "first_sample": np.asarray(c1 - rb.shape[0]),
        })

    solved = s_total - first_chunk
    attribution_acc = success / len(bit_accs) if bit_accs else 0.0
    chains = min(chunk, s_total) * acfg.n_starts
    # pruning acts inside each restart chunk
    cs = args.chunk_starts if 0 < args.chunk_starts < acfg.n_starts else acfg.n_starts
    chain_steps = solved * sum(
        attr.executed_chain_steps(acfg.steps, min(cs, acfg.n_starts - r0), acfg.prune_starts, acfg.prune_frac)
        for r0 in range(0, acfg.n_starts, cs))
    print(f"[attribute] mean bit acc {float(np.mean(bit_accs)):.4f}, attribution acc "
          f"{attribution_acc:.4f} over {s_total} samples")
    if solved <= 0:
        print("[attribute] nothing left to solve (resumed run already complete)")
    else:
        print(f"[attribute] {dt:.2f}s solve on {device}: {solved * acfg.steps / dt:.3f} sample-steps/s, "
              f"{chain_steps / dt:.2f} chain-steps/s ({chains} chains a chunk)")
    if args.profile:
        print("[attribute] phase report:")
        print(prof.format_report(reset=True))
    return AttributeRun(run_dir=run_dir, bit_accs=bit_accs, losses=losses,
                        attribution_acc=attribution_acc, solve_seconds=dt, steps=acfg.steps,
                        chains=chains, chain_steps=chain_steps)


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
