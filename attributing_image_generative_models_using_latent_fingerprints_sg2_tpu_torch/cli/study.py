"""Quality-study CLI: one command per quality table of the reference package.

Counterpart of the reference package's ``cli/study.py``, with its 13
subcommands, operating points and tags.  Every number is measured at
``samples >= 20`` (the default) with Wilson 95% intervals:

- ``headline``: the flagship operating points (64, 128 and 256 px
  self-trained generators, key_len 32 and 64);
- ``robustness``: the eval-strength attacks on the targets, a row an attack;
- ``scaling``: key_len 64 accuracy and the key band's w-space spectrum
  against generator scale;
- ``perceptual``: the solver loss A/B (mse, trained-discriminator features,
  random VGG LPIPS, and both with 2AFC-calibrated heads), clean and attacked;
- ``polish``, ``attackaware``, ``pruning``, ``encoderinit``, ``bestrecipe``:
  the solver modes against the headline / robustness rows, same seeds and
  budget;
- ``identification``: user identification against registry size;
- ``model_attribution``: which of 4 trained generators made an image, and a
  held-out fifth;
- ``spectrum``: kl=64 recovery on generators trained on rank-limited data;
- ``capacity``: watermark visibility (FID, the trained discriminator's
  Frechet distance, LPIPS, MSE) against accuracy, through ``eval.sweep``.

Each finished point is appended to ``<out>.jsonl`` at once, so a run killed
mid-study resumes where it stopped (finished tags are skipped); the table
also lands in ``<out>`` as JSON.  ``--out`` defaults to
``result/study_<name>_torch.json``, beside the reference package's records
and never over them; ``cli.report`` renders these files.  Trained generators
are cached per recipe under ``--cache_dir``.

Run (on the card by default; ``--device cpu`` runs the plain versions):
    python -m attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.cli.study robustness
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

import torch

# Under the temporary directory of the process (TMPDIR), so that two checkouts
# run with temporary directories of their own never share trained generators.
DEFAULT_CACHE = os.path.join(tempfile.gettempdir(), "fp_ckpts_torch")

# Scaling-study grid: (img_size, channel_max, train_steps), the informative
# diagonal of {64,128,256}px x {128,256,512} x {3k,10k,30k} (9 models).
SCALING_MODELS = [
    (64, 128, 3000),
    (64, 128, 30000),
    (64, 256, 10000),
    (128, 128, 3000),
    (128, 128, 30000),
    (128, 256, 10000),
    (128, 256, 30000),
    (256, 256, 10000),
    (256, 512, 10000),
]

ROBUSTNESS_ATTACKS = ["None", "Blur", "Noise", "Jpeg", "Combination", "Crop"]
COMMANDS = ["headline", "robustness", "scaling", "capacity", "perceptual", "polish", "attackaware", "pruning",
            "identification", "bestrecipe", "model_attribution", "spectrum", "encoderinit"]


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("cmd", choices=COMMANDS)
    p.add_argument("--out", type=str, default="",
                   help="table path (default result/study_<cmd>_torch.json; records in <out>.jsonl)")
    p.add_argument("--cache_dir", type=str, default=DEFAULT_CACHE,
                   help="trained-generator cache (.npz per recipe; default $TMPDIR/fp_ckpts_torch)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda (the CUDA kernels; raises without a GPU) or cpu")
    p.add_argument("--samples", type=int, default=20)
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--n", type=int, default=20)
    p.add_argument("--seed", type=int, default=100)
    p.add_argument("--chunk_samples", type=int, default=0,
                   help="solve in chunks of this many samples (memory bound); 0 = the reference "
                   "package's chunking (_auto_chunk), so the records chunk, and draw, as its did")
    p.add_argument("--only", type=str, default="",
                   help="substring filter on the point tag (subset runs)")
    p.add_argument("--compile_cache", type=str, default=None,
                   help="accepted for the reference CLI's flag surface and ignored: nothing is compiled")
    return p


def _load_done(jsonl_path: str) -> dict:
    from ..utils.io import read_jsonl_resumable

    if not os.path.exists(jsonl_path):
        return {}
    return {rec["tag"]: rec for rec in read_jsonl_resumable(jsonl_path)}


# The reference package's chunking of the concurrent chains (chunk_samples x
# concurrent restarts), in chain x pixel x channel units, kept as it is so that
# the port's records split their samples, and so their solves' draws, as the
# reference's records did.  Its constants are that package's memory envelope,
# not a measurement of this port: the port's peak memory a point is printed.
_CHAIN_BUDGET_UNITS = 2.1e8
_CHAIN_CAP = 200


def _auto_chunk(img_size: int, channel_max: int, n_eff: int):
    """(chunk_samples, chunk_starts) keeping concurrent chains inside the
    budget; where one sample's n_eff restarts exceed it, the restarts are
    chunked instead (``attribute_chunked``, identical numerics)."""
    unit = img_size * img_size * channel_max
    chains = max(1, min(_CHAIN_CAP, int(_CHAIN_BUDGET_UNITS // unit)))
    if chains >= n_eff:
        return max(1, chains // max(1, n_eff)), 0
    return 1, chains


def _peak_gb(device: str) -> float:
    """Peak device memory allocated so far by this process, GB (0 on the CPU)."""
    if torch.device(device).type != "cuda":
        return 0.0
    return torch.cuda.max_memory_allocated() / 1e9


def _trained(args, **kw) -> str:
    """``study.ensure_trained`` on this run's cache and device, timed."""
    from ..eval import study

    t0 = time.time()
    path = study.ensure_trained(cache_dir=args.cache_dir, device=args.device, **kw)
    print(f"[study] generator {os.path.basename(path)} ready in {time.time() - t0:.1f}s", flush=True)
    return path


def _pipeline(args, ckpt: str, img_size: int, channel_max: int):
    """``study.build_study_pipeline`` on this run's device, timed (PCA included)."""
    from ..eval import study

    t0 = time.time()
    pipe = study.build_study_pipeline(ckpt, img_size=img_size, channel_max=channel_max, device=args.device)
    print(f"[study] pipeline {img_size}px cm{channel_max} built in {time.time() - t0:.1f}s "
          f"(PCA over 10000 samples)", flush=True)
    return pipe


def _run_points(args, point_specs, out_default: str) -> int:
    """point_specs: list of (tag, model_kwargs, eval_kwargs)."""
    from ..eval import study

    out = args.out or out_default
    jsonl = out + ".jsonl"
    done = _load_done(jsonl)

    pipes = {}  # (ckpt, img, cm) -> pipeline, built lazily and reused
    results = list(done.values())
    for tag, mk, ek in point_specs:
        if args.only and args.only not in tag:
            continue
        if tag in done:
            print(f"[study] {tag}: cached ({done[tag]['mean_bit_acc']:.4f})")
            continue
        t0 = time.time()
        ckpt = _trained(args, img_size=mk["img_size"], channel_max=mk["channel_max"],
                        train_steps=mk["train_steps"], data_dim=mk.get("data_dim", 0))
        pk = (ckpt, mk["img_size"], mk["channel_max"])
        if pk not in pipes:
            pipes.clear()  # one pipeline at a time (device memory)
            if torch.device(args.device).type == "cuda":
                torch.cuda.empty_cache()
            pipes[pk] = _pipeline(args, ckpt, mk["img_size"], mk["channel_max"])
        ek = dict(ek)
        factory = ek.pop("_lpips_factory", None)
        # concurrent chains = chunk x concurrent starts: a point that overrides
        # n_starts shrinks the sample chunk; pruning needs every restart in one
        # solve, so its rows never chunk the restarts
        n_eff = max(1, ek.get("n_starts", args.n))
        chunk, chunk_starts = _auto_chunk(mk["img_size"], mk["channel_max"], n_eff)
        if ek.get("prune_starts"):
            chunk_starts = 0
        if args.chunk_samples:
            chunk, chunk_starts = args.chunk_samples, 0
        call_kw = dict(
            samples=args.samples, steps=args.steps, n_starts=args.n,
            seed=args.seed, chunk_samples=chunk, chunk_starts=chunk_starts,
            lpips_params=(factory() if factory is not None else None),
        )
        call_kw.update(ek)  # the point's spec overrides the defaults (e.g. n_starts)
        rec = study.eval_point(pipes[pk], **call_kw)
        rec["tag"] = tag
        rec["train_steps"] = mk["train_steps"]
        if mk.get("data_dim"):
            rec["data_dim"] = mk["data_dim"]
        rec["bit_sigma_spearman"] = study.bit_sigma_correlation(rec)
        rec["wall_s"] = round(time.time() - t0, 1)
        with open(jsonl, "a") as f:
            f.write(json.dumps(rec) + "\n")
        results.append(rec)
        print(
            f"[study] {tag}: bit_acc {rec['mean_bit_acc']:.4f} "
            f"(CI {rec['bit_acc_ci95'][0]:.4f}-{rec['bit_acc_ci95'][1]:.4f}), "
            f"exact {rec['exact_match_k']}/{rec['samples']} "
            f"(CI {rec['exact_match_ci95'][0]:.2f}-{rec['exact_match_ci95'][1]:.2f}), "
            f"band sigma med {rec['band_sigma_median']:.4f}, "
            f"{rec['wall_s']}s, peak {_peak_gb(args.device):.3f} GB", flush=True)

    with open(out, "w") as f:
        json.dump(results, f, indent=2)
    print(f"[study] wrote {os.path.abspath(out)} ({len(results)} points)")
    return 0


def cmd_headline(args) -> int:
    """Flagship operating points with real statistics (n >= 20); 256 px is
    the reference's default img_size, solved at the same budget."""
    specs = []
    for img, cm, ts in [(64, 128, 3000), (128, 128, 3000), (256, 128, 3000)]:
        mk = {"img_size": img, "channel_max": cm, "train_steps": ts}
        for kl, sig in [(32, 6.0), (64, 3.0), (64, 6.0)]:
            tag = f"{img}px_cm{cm}_t{ts}_kl{kl}_s{sig:g}"
            specs.append((tag, mk, {"key_len": kl, "sigma": sig}))
    return _run_points(args, specs, "result/study_headline_torch.json")


def cmd_spectrum(args) -> int:
    """Does a steeper w-spectrum unlock key_len 64?  Generators trained on
    rank-limited data (``--data_dim`` caps the data manifold's intrinsic
    dimension) concentrate the w-variance on ~data_dim axes; kl=64 recovery is
    measured against the spectrum ratio.  data_dim=0 rows are the full-draw
    anchor (the headline study's cached model)."""
    specs = []
    for d in (4, 8, 16, 0):
        mk = {"img_size": 64, "channel_max": 128, "train_steps": 3000, "data_dim": d}
        dtag = f"d{d}" if d else "dfull"
        for kl, sig in [(64, 3.0), (64, 6.0), (32, 6.0)]:
            tag = f"64px_cm128_t3000_{dtag}_kl{kl}_s{sig:g}"
            specs.append((tag, mk, {"key_len": kl, "sigma": sig}))
    return _run_points(args, specs, "result/study_spectrum_torch.json")


def cmd_robustness(args) -> int:
    """Attack table at the flagship point (64px, kl=32, sigma=6)."""
    mk = {"img_size": 64, "channel_max": 128, "train_steps": 3000}
    specs = [
        (f"64px_kl32_s6_{atk}", mk, {"key_len": 32, "sigma": 6.0, "attack": atk})
        for atk in ROBUSTNESS_ATTACKS
    ]
    return _run_points(args, specs, "result/study_robustness_torch.json")


def cmd_scaling(args) -> int:
    """key_len=64 accuracy + key-band spectrum vs generator scale."""
    specs = []
    for img, cm, ts in SCALING_MODELS:
        mk = {"img_size": img, "channel_max": cm, "train_steps": ts}
        for sig in (3.0, 6.0):
            tag = f"{img}px_cm{cm}_t{ts}_kl64_s{sig:g}"
            specs.append((tag, mk, {"key_len": 64, "sigma": sig}))
    return _run_points(args, specs, "result/study_scaling_torch.json")


def cmd_perceptual(args) -> int:
    """Solver-loss A/B at the flagship point: mse against the in-env
    perceptual backbones (the trained discriminator's features, random-init
    VGG LPIPS), clean and under the attacks.  The ``*_cal`` variants fit the
    lin heads first with the 2AFC machinery (``losses/lpips_train.py``) on
    graded-distortion triplets (``losses/calibrate.py``) and print the rank
    accuracy before and after.  The random VGG is drawn from
    ``torch.Generator().manual_seed(0)``: another stream than the reference's
    ``PRNGKey(0)``."""
    from ..losses.calibrate import calibrate_lin_heads, rank_accuracy
    from ..losses.disc_percept import load_disc_percept
    from ..losses.lpips import init_lpips_params

    mk = {"img_size": 64, "channel_max": 128, "train_steps": 3000}
    # lazy: train (with the disc export) only when a backbone factory runs, so a
    # fully cached jsonl does not retrain a wiped checkpoint cache
    _ckpt_box: list = []

    def _ckpt() -> str:
        if not _ckpt_box:
            _ckpt_box.append(_trained(args, img_size=mk["img_size"], channel_max=mk["channel_max"],
                                      train_steps=mk["train_steps"], need_disc=True))
        return _ckpt_box[0]

    def _calibrated(make_base, seed):
        cache = []  # fit once a backbone, not once an attack point: the seed is fixed

        def factory():
            if not cache:
                base = make_base()
                t0 = time.time()
                r0 = rank_accuracy(base, size=mk["img_size"])
                fitted = calibrate_lin_heads(base, generator=torch.Generator().manual_seed(seed),
                                             size=mk["img_size"])
                r1 = rank_accuracy(fitted, size=mk["img_size"])
                print(f"[study] 2AFC calibration: rank acc {r0:.3f} -> {r1:.3f} "
                      f"({time.time() - t0:.1f}s)", flush=True)
                cache.append(fitted)
            return cache[0]

        return factory

    def _disc():
        return load_disc_percept(_ckpt() + ".disc.npz", device=args.device)

    def _vgg():
        return init_lpips_params(torch.Generator().manual_seed(0), args.device)

    backbones = {
        "mse": (("mse",), None),
        "disc": (("perceptual",), _disc),
        "vgg_rand": (("perceptual",), _vgg),
        "disc_cal": (("perceptual",), _calibrated(_disc, 11)),
        "vgg_cal": (("perceptual",), _calibrated(_vgg, 12)),
    }
    specs = []
    for name in ["mse", "disc", "vgg_rand", "disc_cal", "vgg_cal"]:
        for atk in ["None", "Jpeg", "Noise", "Crop"]:
            tag = f"64px_kl32_s6_{name}_{atk}"
            (loss,), mkparams = backbones[name]
            specs.append(
                (tag, mk,
                 {"key_len": 32, "sigma": 6.0, "attack": atk, "loss": loss,
                  "_lpips_factory": mkparams})
            )
    return _run_points(args, specs, "result/study_perceptual_torch.json")


def cmd_attackaware(args) -> int:
    """Attack-aware solving A/B at the flagship point: each attack solved
    pushing the estimate through the same deterministic channel model; the
    ``*_aware`` rows pair with the matching robustness rows (same seeds and
    budget)."""
    mk = {"img_size": 64, "channel_max": 128, "train_steps": 3000}
    specs = [
        (f"64px_kl32_s6_{atk}_aware", mk,
         {"key_len": 32, "sigma": 6.0, "attack": atk, "attack_aware": True})
        for atk in ["Blur", "Jpeg", "Crop", "Combination"]
    ]
    return _run_points(args, specs, "result/study_attackaware_torch.json")


def cmd_encoderinit(args) -> int:
    """Amortized-encoder initialization A/B (``fingerprint/encoder.py``): the
    headline wall points and every attacked operating point re-solved at the
    same budget with the restarts seeded by a learned inverter (trained on the
    attack's true channel).  Self-contained: every ``*_enc`` row has a
    ``*_lhs`` baseline row on the same model, seeds and budget; the attacked
    points add ``*_aware`` and ``*_encaware`` rows; the kl=64 wall points add
    encoder-budget rows; 256 px adds one blind / encoder pair."""
    mk = {"img_size": 64, "channel_max": 128, "train_steps": 3000}
    mk128 = {"img_size": 128, "channel_max": 128, "train_steps": 3000}
    points = [
        ("64px_cm128_t3000_kl64_s6", mk, {"key_len": 64, "sigma": 6.0}),
        ("64px_cm128_t3000_kl64_s3", mk, {"key_len": 64, "sigma": 3.0}),
        ("64px_cm128_t3000_kl32_s6", mk, {"key_len": 32, "sigma": 6.0}),
        ("128px_cm128_t3000_kl64_s6", mk128, {"key_len": 64, "sigma": 6.0}),
        ("64px_kl32_s6_Crop", mk,
         {"key_len": 32, "sigma": 6.0, "attack": "Crop"}),
        ("64px_kl32_s6_Jpeg", mk,
         {"key_len": 32, "sigma": 6.0, "attack": "Jpeg"}),
        ("64px_kl32_s6_Blur", mk,
         {"key_len": 32, "sigma": 6.0, "attack": "Blur"}),
        ("64px_kl32_s6_Noise", mk,
         {"key_len": 32, "sigma": 6.0, "attack": "Noise"}),
        ("64px_kl32_s6_Combination", mk,
         {"key_len": 32, "sigma": 6.0, "attack": "Combination"}),
    ]
    specs = []
    for tag, mks, ek in points:
        specs.append((f"{tag}_lhs", mks, dict(ek)))
        specs.append((f"{tag}_enc", mks, {**ek, "init": "encoder"}))
        if ek.get("attack", "None") != "None":
            specs.append((f"{tag}_aware", mks, {**ek, "attack_aware": True}))
            specs.append((f"{tag}_encaware", mks,
                          {**ek, "init": "encoder", "attack_aware": True}))
    for tag, mks in (("128px_cm128_t3000_kl64_s6", mk128),
                     ("64px_cm128_t3000_kl64_s6", mk)):
        base = {"key_len": 64, "sigma": 6.0, "init": "encoder"}
        specs.append((f"{tag}_enc6k", mks, {**base, "encoder_steps": 6000}))
        specs.append((f"{tag}_enc6kj50", mks,
                      {**base, "encoder_steps": 6000, "encoder_jitter": 0.5}))
        specs.append((f"{tag}_enc24k", mks, {**base, "encoder_steps": 24000}))
    mk256 = {"img_size": 256, "channel_max": 128, "train_steps": 3000}
    specs.append(("256px_cm128_t3000_kl64_s6_lhs", mk256,
                  {"key_len": 64, "sigma": 6.0}))
    # batch 16 at 256px, 4x the steps: the same image count as 6000 x 64
    specs.append(("256px_cm128_t3000_kl64_s6_enc6k", mk256,
                  {"key_len": 64, "sigma": 6.0, "init": "encoder",
                   "encoder_steps": 24000, "encoder_batch": 16}))
    return _run_points(args, specs, "result/study_encoderinit_torch.json")


def cmd_pruning(args) -> int:
    """Restart-pruning (successive halving) A/B at the flagship points: all 20
    restarts warmed for 25% of the schedule, then the best 5 (44% of the
    full solve's chain-steps); and n=40 pruned to 8 (0.80x).  Rows pair with
    the headline rows."""
    specs = []
    for img, cm, ts in [(64, 128, 3000), (128, 128, 3000)]:
        mk = {"img_size": img, "channel_max": cm, "train_steps": ts}
        for kl, sig in [(32, 6.0), (64, 6.0)]:
            base = {"key_len": kl, "sigma": sig}
            specs.append(
                (f"{img}px_cm{cm}_t{ts}_kl{kl}_s{sig:g}_prune20to5", mk,
                 {**base, "prune_starts": 5}))
            specs.append(
                (f"{img}px_cm{cm}_t{ts}_kl{kl}_s{sig:g}_n40prune8", mk,
                 {**base, "prune_starts": 8, "n_starts": 40}))
    return _run_points(args, specs, "result/study_pruning_torch.json")


def cmd_polish(args) -> int:
    """Discrete bit-polish A/B: the headline points re-solved with 2 greedy
    sign-flip sweeps (5% accept margin) after the continuous solve; rows
    pair with the headline rows."""
    specs = []
    for img, cm, ts in [(64, 128, 3000), (128, 128, 3000)]:
        mk = {"img_size": img, "channel_max": cm, "train_steps": ts}
        for kl, sig in [(32, 6.0), (64, 3.0), (64, 6.0)]:
            tag = f"{img}px_cm{cm}_t{ts}_kl{kl}_s{sig:g}_polish2_soft"
            specs.append(
                (tag, mk,
                 {"key_len": kl, "sigma": sig, "polish_sweeps": 2,
                  "polish_margin": 0.05})
            )
    return _run_points(args, specs, "result/study_polish_torch.json")


def cmd_bestrecipe(args) -> int:
    """The composed solver at the headline budget: n=50 restarts warmed for
    25% of the schedule and pruned to 10 (0.25*2000*50 + 0.75*2000*10 =
    40,000 chain-steps a sample, the headline's 20 x 2000), 2 soft-sign polish
    sweeps; attacked rows also solve attack-aware with the trained
    discriminator's features.  Clean rows pair with headline, attacked rows
    with robustness."""
    from ..losses.disc_percept import load_disc_percept

    recipe = {
        "n_starts": 50, "prune_starts": 10, "prune_frac": 0.25,
        "polish_sweeps": 2, "polish_margin": 0.05,
    }
    specs = []
    for img in (64, 128):
        mk = {"img_size": img, "channel_max": 128, "train_steps": 3000}
        for kl, sig in [(32, 6.0), (64, 3.0), (64, 6.0)]:
            tag = f"{img}px_cm128_t3000_kl{kl}_s{sig:g}_best"
            specs.append((tag, mk, {"key_len": kl, "sigma": sig, **recipe}))

    mk64 = {"img_size": 64, "channel_max": 128, "train_steps": 3000}
    _ckpt_box: list = []

    def _disc_factory():
        if not _ckpt_box:
            ckpt = _trained(args, img_size=64, channel_max=128, train_steps=3000, need_disc=True)
            _ckpt_box.append(load_disc_percept(ckpt + ".disc.npz", device=args.device))
        return _ckpt_box[0]

    for atk in ("Jpeg", "Crop"):
        specs.append((
            f"64px_kl32_s6_{atk}_best", mk64,
            {"key_len": 32, "sigma": 6.0, "attack": atk,
             "attack_aware": True, "loss": "perceptual",
             "_lpips_factory": _disc_factory, **recipe},
        ))
    return _run_points(args, specs, "result/study_bestrecipe_torch.json")


def cmd_model_attribution(args) -> int:
    """Model-level attribution: a registry of 4 generators of one recipe
    (training seeds 0-3, the hardest closed-set case) and a held-out fifth
    (seed 4) for the open set; decision accuracy with CIs, margins, the
    calibrated open-set operating point and the threshold sweeps
    (``eval/model_attribution_study.py``)."""
    from ..eval.model_attribution_study import model_attribution_point

    out = args.out or "result/study_model_attribution_torch.json"
    jsonl = out + ".jsonl"
    done = _load_done(jsonl)
    recs = list(done.values())

    points = [
        ("modelattr_64px_kl32_s6", {"key_len": 32, "sigma": 6.0}),
        ("modelattr_64px_kl64_s6", {"key_len": 64, "sigma": 6.0}),
    ]
    pipes_box: dict = {}

    def _pipes():
        """Registry seeds 0-3 + held-out seed 4, trained + PCA'd once."""
        if pipes_box:
            return pipes_box
        for s in range(5):
            ckpt = _trained(args, img_size=64, channel_max=128, train_steps=3000, seed=s)
            pipes_box[f"seed{s}"] = _pipeline(args, ckpt, 64, 128)
        return pipes_box

    for tag, kw in points:
        if args.only and args.only not in tag:
            continue
        if tag in done:
            print(f"[study] {tag}: cached "
                  f"(decision acc {done[tag]['decision_acc']:.3f})")
            continue
        pipes = _pipes()
        registry = {n: pipes[n] for n in ("seed0", "seed1", "seed2", "seed3")}
        held_out = {"seed4": pipes["seed4"]}
        t0 = time.time()
        rec = model_attribution_point(
            registry, held_out,
            samples_per_model=args.samples,
            seed=args.seed,
            chunk_samples=(args.chunk_samples
                           or _auto_chunk(64, 128, 8)[0]),
            **kw,
        )
        rec["tag"] = tag
        rec["wall_s"] = round(time.time() - t0, 1)
        with open(jsonl, "a") as f:
            f.write(json.dumps(rec) + "\n")
        recs.append(rec)
        print(f"[study] {tag}: decision acc {rec['decision_acc']:.3f} "
              f"(CI {rec['decision_acc_ci95'][0]:.2f}-"
              f"{rec['decision_acc_ci95'][1]:.2f}), "
              f"FR@thr {rec['false_reject_at_threshold']:.3f}, "
              f"FA@thr {rec['false_accept_at_threshold']:.3f}, "
              f"loss AUC {rec['open_set_auc']:.3f}, "
              f"margin AUC "
              f"{rec.get('margin_open_set_auc') or float('nan'):.3f}, "
              f"{rec['wall_s']}s, peak {_peak_gb(args.device):.3f} GB")
    with open(out, "w") as f:
        json.dump(recs, f, indent=2)
    print(f"[study] wrote {os.path.abspath(out)} ({len(recs)} points)")
    return 0


def cmd_capacity(args) -> int:
    """Watermark visibility (FID, discriminator-feature FD, LPIPS, MSE)
    against accuracy on the 64 px recipe (with its discriminator): key_len
    (32, 64) x sigma (3, 6), ``max(8, samples // 2)`` samples, solved at a
    fixed 500-step / 8-restart mse budget in bf16 with the visibility metrics;
    then the same grid (same seed, so the same targets) at the headline budget
    (``--steps`` / ``--n``) without FID, merged in as ``mean_bit_acc_full`` /
    ``attribution_acc_full`` (``full_budget``), so the table reads at the
    headline rows' operating point."""
    from ..config import AttributionConfig, ModelConfig
    from ..eval.sweep import run_sweep
    from ..losses.disc_percept import load_disc_percept

    ckpt = _trained(args, img_size=64, channel_max=128, train_steps=3000, need_disc=True)
    disc_params = load_disc_percept(ckpt + ".disc.npz", device=args.device)["disc"]
    mcfg = ModelConfig(img_size=64, channel_max=128, ckpt=ckpt)
    samples = max(8, args.samples // 2)
    grid = dict(key_lens=(32, 64), sigmas=(3.0, 6.0), samples=samples, ckpt_path=ckpt, dtype="bfloat16",
                device=args.device)
    t0 = time.time()
    pts = run_sweep(args.seed, mcfg, acfg=AttributionConfig(steps=500, n_starts=8, loss="mse"), with_fid=True,
                    disc_params=disc_params, **grid)
    print(f"[study] capacity sweep (500/8, FID) in {time.time() - t0:.1f}s, peak {_peak_gb(args.device):.3f} GB",
          flush=True)
    t0 = time.time()
    pts_full = run_sweep(args.seed, mcfg, acfg=AttributionConfig(steps=args.steps, n_starts=args.n, loss="mse"),
                         with_fid=False, **grid)
    print(f"[study] capacity sweep ({args.steps}/{args.n}) in {time.time() - t0:.1f}s", flush=True)
    recs = [dataclasses.asdict(p) for p in pts]
    full_by_key = {(p.key_len, p.sigma, p.shift): p for p in pts_full}
    for r in recs:
        fp = full_by_key.get((r["key_len"], r["sigma"], r["shift"]))
        r["mean_bit_acc_full"] = fp.mean_bit_acc if fp else None
        r["attribution_acc_full"] = fp.attribution_acc if fp else None
        r["full_budget"] = f"{args.steps}/{args.n}"
        r["samples"] = samples
    out = args.out or "result/study_capacity_torch.json"
    with open(out, "w") as f:
        json.dump(recs, f, indent=2)
    print(f"[study] wrote {os.path.abspath(out)} ({len(recs)} points, incl. full-budget bit-acc column)")
    return 0


def cmd_identification(args) -> int:
    """User identification against registry size (``eval/identification.py``):
    solve once at an operating point, decode the planted user against growing
    registries (soft ML vs hard Hamming), with the union bound the measured
    per-bit error implies; kl=32 and the reference's kl=64, clean, attacked
    and attack-aware, rejection-sampled and Reed-Muller issuance, LHS and
    encoder starts."""
    from ..eval.identification import identification_point

    out = args.out or "result/study_identification_torch.json"
    jsonl = out + ".jsonl"
    done = _load_done(jsonl)  # crash/resume safe, like every other study
    recs = list(done.values())
    pipe = None
    id_points = [
        ("kl32_s6_None",
         dict(key_len=32, sigma=6.0, min_distance=6,
              registry_sizes=(10, 100, 1000), attack="None")),
        ("kl32_s6_Jpeg",
         dict(key_len=32, sigma=6.0, min_distance=6,
              registry_sizes=(10, 100, 1000), attack="Jpeg")),
        ("kl32_s6_Crop",
         dict(key_len=32, sigma=6.0, min_distance=6,
              registry_sizes=(10, 100, 1000), attack="Crop")),
        ("kl64_s6_None",
         dict(key_len=64, sigma=6.0, min_distance=12,
              registry_sizes=(10, 100, 1000, 10000, 100000),
              attack="None")),
        ("kl64_s3_None",
         dict(key_len=64, sigma=3.0, min_distance=12,
              registry_sizes=(10, 100, 1000, 10000, 100000),
              attack="None")),
        ("kl64_s3_Jpeg",
         dict(key_len=64, sigma=3.0, min_distance=12,
              registry_sizes=(10, 100, 1000, 10000, 100000),
              attack="Jpeg")),
        ("kl64_s3_Crop",
         dict(key_len=64, sigma=3.0, min_distance=12,
              registry_sizes=(10, 100, 1000, 10000, 100000),
              attack="Crop")),
        ("kl64_s3_Jpeg_aware",
         dict(key_len=64, sigma=3.0, min_distance=12,
              registry_sizes=(10, 100, 1000, 10000, 100000),
              attack="Jpeg", attack_aware=True)),
        ("kl64_s3_Crop_aware",
         dict(key_len=64, sigma=3.0, min_distance=12,
              registry_sizes=(10, 100, 1000, 10000, 100000),
              attack="Crop", attack_aware=True)),
        ("kl64_s3_None_rm",
         dict(key_len=64, sigma=3.0, issuance="rm",
              registry_sizes=(1000, 10000, 100000, 1000000),
              attack="None")),
        ("kl64_s3_Jpeg_aware_rm",
         dict(key_len=64, sigma=3.0, issuance="rm",
              registry_sizes=(1000, 10000, 100000, 1000000),
              attack="Jpeg", attack_aware=True)),
        ("kl64_s3_Crop_aware_rm",
         dict(key_len=64, sigma=3.0, issuance="rm",
              registry_sizes=(1000, 10000, 100000, 1000000),
              attack="Crop", attack_aware=True)),
        ("kl64_s3_None_rm_enc",
         dict(key_len=64, sigma=3.0, issuance="rm",
              registry_sizes=(1000, 10000, 100000, 1000000),
              attack="None", init="encoder")),
        ("kl64_s3_Jpeg_encaware_rm",
         dict(key_len=64, sigma=3.0, issuance="rm",
              registry_sizes=(1000, 10000, 100000, 1000000),
              attack="Jpeg", attack_aware=True, init="encoder")),
        ("kl64_s3_Crop_encaware_rm",
         dict(key_len=64, sigma=3.0, issuance="rm",
              registry_sizes=(1000, 10000, 100000, 1000000),
              attack="Crop", attack_aware=True, init="encoder")),
    ]
    for suffix, kw in id_points:
        tag = f"ident_64px_{suffix}"
        if args.only and args.only not in tag:
            continue
        if tag in done:
            print(f"[study] {tag}: cached "
                  f"(bit acc {done[tag]['mean_bit_acc']:.4f})")
            continue
        if pipe is None:
            ckpt = _trained(args, img_size=64, channel_max=128, train_steps=3000)
            pipe = _pipeline(args, ckpt, 64, 128)
        t0 = time.time()
        rec = identification_point(
            pipe,
            samples=args.samples, steps=args.steps, n_starts=args.n,
            seed=args.seed,
            chunk_samples=(
                args.chunk_samples
                or _auto_chunk(64, 128, max(1, args.n))[0]
            ),
            **kw,
        )
        rec["tag"] = tag
        rec["wall_s"] = round(time.time() - t0, 1)
        with open(jsonl, "a") as f:
            f.write(json.dumps(rec) + "\n")
        recs.append(rec)
        print(f"[study] {tag}: p_bit {rec['measured_p_bit']:.4f} "
              f"(bit acc {rec['mean_bit_acc']:.4f}), {rec['wall_s']}s, "
              f"peak {_peak_gb(args.device):.3f} GB")
        for row in rec["by_registry_size"]:
            print(
                f"[study]   N={row['registry_size']}: soft "
                f"{row['soft_accuracy']:.3f} "
                f"(CI {row['soft_ci95'][0]:.2f}-{row['soft_ci95'][1]:.2f}), "
                f"hard {row['hard_accuracy']:.3f}, "
                f"margin {row['mean_margin_nats']:.1f} nats, "
                f"union bound err <= {row['union_bound_error']:.3g}"
            )
    with open(out, "w") as f:
        json.dump(recs, f, indent=2)
    print(f"[study] wrote {os.path.abspath(out)} ({len(recs)} points)")
    return 0


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    from ..utils.device import resolve_device

    resolve_device(args.device)  # raises without CUDA unless --device cpu
    os.makedirs("result", exist_ok=True)
    return {
        "headline": cmd_headline,
        "robustness": cmd_robustness,
        "scaling": cmd_scaling,
        "capacity": cmd_capacity,
        "perceptual": cmd_perceptual,
        "polish": cmd_polish,
        "attackaware": cmd_attackaware,
        "pruning": cmd_pruning,
        "identification": cmd_identification,
        "bestrecipe": cmd_bestrecipe,
        "model_attribution": cmd_model_attribution,
        "spectrum": cmd_spectrum,
        "encoderinit": cmd_encoderinit,
    }[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
