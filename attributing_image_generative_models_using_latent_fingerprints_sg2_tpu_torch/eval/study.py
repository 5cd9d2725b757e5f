"""The quality-study measurement: one operating point, its statistics and its
key-band spectrum.

Counterpart of the reference package's ``eval/study.py``:

- :func:`eval_point` embeds ``samples`` keys, optionally attacks the targets,
  solves them with the reference's budget semantics (``steps`` x ``n_starts``
  restarts a sample, LHS starts, argmin over restarts) and reports bit
  accuracy and exact match with 95% confidence intervals, the per-bit
  accuracy and the w-space variance spectrum of the key band;
- :func:`bit_sigma_correlation`, the tie-corrected Spearman rank correlation
  of per-bit accuracy and key-band sigma;
- :func:`ensure_trained` trains (``cli.train``) or reuses a cached generator
  of a recipe; :func:`build_study_pipeline` builds one pipeline that serves
  every grid point of a model.

``cli.study`` drives these and ``cli.report`` renders the records.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..attacks import make_attack
from ..config import AttackConfig, AttributionConfig, FingerprintConfig, ModelConfig
from ..fingerprint import attribute as attr
from ..fingerprint import embed as fpe
from ..fingerprint import pipeline as pl
from ..utils.lhs import fold_in


def wilson_ci(k: int, n: int, z: float = 1.96) -> tuple:
    """Wilson score interval for a binomial proportion (95% by default);
    exact-match rates at small n are otherwise coarsely quantized."""
    if n == 0:
        return (0.0, 1.0)
    p = k / n
    denom = 1.0 + z * z / n
    center = (p + z * z / (2 * n)) / denom
    half = (z / denom) * math.sqrt(p * (1 - p) / n + z * z / (4 * n * n))
    return (max(0.0, center - half), min(1.0, center + half))


def build_study_pipeline(
    ckpt_path: Optional[str],
    *,
    img_size: int,
    channel_max: int = 512,
    style_dim: int = 512,
    n_mlp: int = 8,
    n_pca_samples: int = 10000,
    seed: int = 0,
    device="cuda",
) -> pl.Pipeline:
    """One generator and one PCA serving every grid point of a model (the
    basis is re-sliced per point); no LPIPS (a point brings its own).  Random
    weights when ``ckpt_path`` is None.  On the card unless ``device="cpu"``."""
    mcfg = ModelConfig(img_size=img_size, channel_max=channel_max, style_dim=style_dim, n_mlp=n_mlp,
                       ckpt=ckpt_path)
    fpcfg = FingerprintConfig(key_len=64, shift=style_dim - 64, n_pca_samples=n_pca_samples)
    return pl.build_pipeline(mcfg, fpcfg, generator=torch.Generator().manual_seed(seed), device=device,
                             ckpt_path=ckpt_path, want_lpips=False)


def point_seed(seed: int, key_len: int, shift: int, sigma: float) -> int:
    """The seed of one operating point's draws: ``seed`` folded with the
    reference's ``hash((key_len, shift, int(sigma * 16))) % 2**30`` (Python's
    hash of a tuple of ints is the same in every process)."""
    return fold_in(seed, hash((key_len, shift, int(sigma * 16))) % (1 << 30)).initial_seed()


def eval_point(
    pipe: pl.Pipeline,
    *,
    key_len: int,
    sigma: float,
    shift: Optional[int] = None,
    samples: int = 20,
    steps: int = 2000,
    n_starts: int = 20,
    loss: str = "mse",
    attack: str = "None",
    attack_cfg: Optional[AttackConfig] = None,
    lpips_params: Any = None,
    seed: int = 100,
    dtype: str = "bfloat16",
    chunk_samples: int = 0,
    chunk_starts: int = 0,
    polish_sweeps: int = 0,
    polish_margin: float = 0.05,
    attack_aware: bool = False,
    prune_starts: int = 0,
    prune_frac: float = 0.25,
    init: str = "lhs",
    encoder_steps: int = 1500,
    encoder_batch: int = 0,
    encoder_jitter: float = 0.25,
) -> Dict[str, Any]:
    """Embed ``samples`` keys, attack the targets if asked, invert them, and
    report accuracy with confidence intervals and per-bit diagnostics.
    ``attack_aware`` pushes the solver's estimate through the attack's
    deterministic channel model; ``init="encoder"`` seeds the restarts with an
    encoder trained on the attack's true channel.

    Draws: the point's seed (:func:`point_seed`) gives the content
    (``fold_in(., 0)``), the key bits (1), the attack (2) and the solves (3,
    each sample chunk folded with its first index); the encoder trains from
    ``fold_in(., 7)`` and starts from ``fold_in(., 8)``.  ``dtype`` is the
    solver's compute dtype (bfloat16 by default, as in the reference's study)."""
    d = pipe.mcfg.style_space_dim
    if shift is None:
        shift = d - key_len
    fp = FingerprintConfig(key_len=key_len, shift=shift, sigma=sigma)
    basis = fpe.build_basis(pipe.pca, fp)
    acfg = AttributionConfig(
        steps=steps, n_starts=n_starts, loss=loss, polish_sweeps=polish_sweeps, polish_margin=polish_margin,
        solver_attack=(attack if attack_aware else "None"), prune_starts=prune_starts, prune_frac=prune_frac)

    pseed = point_seed(seed, key_len, shift, sigma)
    alpha = fpe.sample_alpha(basis, samples, fold_in(pseed, 0))
    bits = fpe.sample_key_bits(key_len, samples, fold_in(pseed, 1), pipe.device)
    _, wx = fpe.embed(basis, alpha, bits)
    targets = torch.clamp(pl.synthesize(pipe, wx), -1.0, 1.0)
    atk_cfg_full = None
    if attack != "None":
        atk_cfg_full = dataclasses.replace(attack_cfg if attack_cfg is not None else AttackConfig(),
                                           augmentation=attack)
        with torch.no_grad():
            targets = make_attack(atk_cfg_full)(targets, fold_in(pseed, 2))

    enc_meta: Dict[str, Any] = {}
    alpha_init = key_init = None
    if init == "encoder":
        from ..fingerprint import encoder as enc_mod

        t_enc = time.time()
        # the provider knows the channel it tests: the encoder trains through that
        # channel's true stochastic model whenever the targets are attacked
        enc_params, enc_curve, ecfg = enc_mod.train_for_init(
            pipe.gen_params, basis, pipe.noise, mcfg=pipe.mcfg, seed=pseed, steps=encoder_steps,
            jitter=encoder_jitter, batch=encoder_batch, attack_cfg=atk_cfg_full)
        alpha_init, key_init = enc_mod.encoder_solve_init(enc_params, basis, targets, n_starts,
                                                          fold_in(pseed, 8), jitter=encoder_jitter)
        enc_acc = enc_mod.encoder_bit_accuracy(enc_params, targets, bits).cpu().numpy()
        enc_meta = {
            "init": "encoder",
            "encoder_steps": encoder_steps,
            "encoder_batch": ecfg.batch,
            "encoder_jitter": encoder_jitter,
            "encoder_bit_acc": float(enc_acc.mean()),
            "encoder_exact_k": int((enc_acc >= 1.0).sum()),
            "encoder_final_train_loss": float(enc_curve[-1]),
            "encoder_train_wall_s": round(time.time() - t_enc, 1),
        }

    chunk = chunk_samples or samples
    res_bits, res_losses, res_accs = [], [], []
    want_all = bits.cpu().numpy()
    for c0 in range(0, samples, chunk):
        c1 = min(c0 + chunk, samples)
        init_kw = {}
        if alpha_init is not None:
            init_kw = dict(alpha_init=alpha_init[c0:c1], key_init=key_init[c0:c1])
        res = attr.attribute_chunked(
            pipe.gen_params, lpips_params if loss == "perceptual" else None, basis, pipe.noise, targets[c0:c1],
            mcfg=pipe.mcfg, acfg=acfg, generator=fold_in(fold_in(pseed, 3), c0), chunk_starts=chunk_starts,
            dtype=dtype, attack_cfg=(atk_cfg_full if attack_aware else None), **init_kw)
        got = res.key_bits.detach().cpu().numpy()
        ok = got == want_all[c0:c1]
        res_bits.append(ok)
        res_losses.append(res.loss.detach().cpu().numpy().astype(np.float64))
        res_accs.append(ok.mean(axis=1))

    correct = np.concatenate(res_bits, axis=0)  # [S, K] bool
    accs = np.concatenate(res_accs, axis=0)
    losses = np.concatenate(res_losses, axis=0)
    exact = int((accs >= 1.0).sum())
    lo, hi = wilson_ci(exact, samples)
    # mean bit-acc CI: normal approximation over the per-sample accuracies
    sem = float(accs.std(ddof=1) / np.sqrt(samples)) if samples > 1 else 0.0

    sig = pipe.pca.sigma.detach().cpu().numpy().astype(np.float64)
    band = sig[shift: shift + key_len]
    return {
        "img_size": pipe.mcfg.img_size,
        "channel_max": pipe.mcfg.channel_max,
        "ckpt": pipe.mcfg.ckpt,
        "key_len": key_len,
        "sigma": float(sigma),
        "shift": int(shift),
        "attack": attack,
        "loss": loss,
        "samples": samples,
        "steps": steps,
        "n_starts": n_starts,
        # executed chain-steps a sample: the pruning rows' budget against the full solve
        "chain_steps_per_sample": attr.executed_chain_steps(steps, n_starts, prune_starts, prune_frac),
        "mean_bit_acc": float(accs.mean()),
        "bit_acc_ci95": [float(accs.mean() - 1.96 * sem), float(accs.mean() + 1.96 * sem)],
        "bit_acc_min": float(accs.min()),
        "exact_match": exact / samples,
        "exact_match_k": exact,
        "exact_match_ci95": [lo, hi],
        "mean_final_loss": float(losses.mean()),
        # per-key-bit accuracy across samples, aligned with the band's spectrum
        "per_bit_acc": correct.mean(axis=0).tolist(),
        "band_sigma": band.tolist(),
        "band_sigma_median": float(np.median(band)),
        "content_sigma_median": float(np.median(sig[:shift])),
        "spectrum_decile_sigmas": np.quantile(sig, np.linspace(0, 1, 11)).tolist(),
        **enc_meta,
    }


def _average_ranks(x: np.ndarray) -> np.ndarray:
    """Ranks with ties assigned the group-average rank (0-based)."""
    order = np.argsort(x, kind="stable")
    ranks = np.empty(x.shape[0], np.float64)
    sx = x[order]
    i = 0
    while i < x.shape[0]:
        j = i
        while j < x.shape[0] and sx[j] == sx[i]:
            j += 1
        ranks[order[i:j]] = (i + j - 1) / 2.0
        i = j
    return ranks


def bit_sigma_correlation(point: Dict[str, Any]) -> Optional[float]:
    """Spearman rank correlation of per-bit accuracy and the sigma of the PC
    carrying each bit (positive: low-sigma axes lose bits), tie-corrected
    (Pearson of average ranks: per-bit accuracies come in large tie groups).
    Pure numpy; None where either side has zero variance (JSON-safe, unlike NaN)."""
    acc = np.asarray(point["per_bit_acc"], np.float64)
    sig = np.asarray(point["band_sigma"], np.float64)
    if acc.std() == 0 or sig.std() == 0:
        return None
    rho = float(np.corrcoef(_average_ranks(acc), _average_ranks(sig))[0, 1])
    return rho if np.isfinite(rho) else None


def ensure_trained(
    *,
    img_size: int,
    channel_max: int,
    train_steps: int,
    cache_dir: str,
    batch: int = 16,
    seed: int = 0,
    data_sharp: bool = False,
    data_dim: int = 0,
    need_disc: bool = False,
    device="cuda",
) -> str:
    """The path of a trained generator of this recipe (rosinality-layout
    ``.npz``): reused from ``cache_dir`` when there, else trained by
    ``cli.train`` on ``device``.  ``need_disc`` also requires the
    discriminator's export (``<path>.disc.npz``, the perceptual backbone) and
    retrains a cache that lacks it."""
    os.makedirs(cache_dir, exist_ok=True)
    tag = f"sg2_{img_size}px_cm{channel_max}_s{train_steps}_b{batch}_seed{seed}"
    if data_sharp:
        tag += "_sharp"
    if data_dim:
        tag += f"_d{data_dim}"
    path = os.path.join(cache_dir, tag + ".npz")
    if os.path.exists(path) and (not need_disc or os.path.exists(path + ".disc.npz")):
        return path
    from ..cli import train as train_cli

    argv = [
        "--img_size", str(img_size), "--channel_max", str(channel_max),
        "--steps", str(train_steps), "--batch", str(batch),
        "--chunk", "150", "--log_every", "5", "--seed", str(seed),
        "--out", path,
    ]
    if data_sharp:
        argv.append("--data_sharp")
    if data_dim:
        argv += ["--data_dim", str(data_dim)]
    rc = train_cli.main(argv + ["--device", str(device)])
    if rc != 0 or not os.path.exists(path):
        raise RuntimeError(f"training failed for {tag}")
    return path


def points_to_json(points: List[Dict[str, Any]]) -> str:
    return json.dumps(points, indent=2)
