"""Measured model-level attribution: decision accuracy and the open-set
operating curves over a registry of generators.

Counterpart of the reference package's ``eval/model_attribution_study.py``:

- **Registry**: M generators; **held out**: generators outside it, their
  images fingerprinted under their own bases (another provider's model).
- **Decision**: the minimum best-restart loss over the registry
  (``fingerprint.model_attribution``); margins and the loss matrix are kept.
- **Calibration / evaluation split**: the first ``calib_frac`` of each
  registry model's own samples set the open-set threshold (p99 x slack); the
  rates are read on the rest, so the threshold never judges its own samples.
- **Open-set statistics**, each swept over its pooled range with its AUC:
  the best loss, the runner-up / best margin, the restart coherence of the
  chosen model's solve, and margin x coherence.

The solver's compute dtype defaults to bfloat16, as the reference's does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

from ..config import AttributionConfig, FingerprintConfig
from ..fingerprint import embed as fpe
from ..fingerprint import pipeline as pl
from ..fingerprint.model_attribution import attribute_model, calibrate_open_set_threshold
from ..utils.lhs import fold_in
from .study import wilson_ci


def _with_basis(pipe: pl.Pipeline, key_len: int, sigma: float) -> pl.Pipeline:
    """The pipeline with its basis re-sliced at (key_len, sigma), the key on
    the last ``key_len`` components (shift = style_space_dim - key_len); the
    PCA is reused."""
    d = pipe.mcfg.style_space_dim
    fp = FingerprintConfig(key_len=key_len, shift=d - key_len, sigma=sigma)
    return dataclasses.replace(pipe, fpcfg=fp, basis=fpe.build_basis(pipe.pca, fp))


@torch.no_grad()
def _fingerprinted_targets(pipe: pl.Pipeline, generator: torch.Generator, samples: int,
                           clip: bool) -> Tuple[np.ndarray, np.ndarray]:
    """``samples`` fingerprinted images and their key bits (host arrays),
    clipped to the stored-image range.  Random-init test generators leave
    [-1, 1] and clipping would push their targets off the manifold, so tests
    turn the clip off."""
    alpha = fpe.sample_alpha(pipe.basis, samples, fold_in(generator, 0))
    bits = fpe.sample_key_bits(pipe.fpcfg.key_len, samples, fold_in(generator, 1), pipe.device)
    _, wx = fpe.embed(pipe.basis, alpha, bits)
    targets = pl.synthesize(pipe, wx)
    if clip:
        targets = torch.clamp(targets, -1.0, 1.0)
    return targets.cpu().numpy(), bits.cpu().numpy()


def _openset_sweep(stat_in: np.ndarray, stat_out: np.ndarray, accept_if_geq: bool):
    """Threshold sweep over the pooled values of an open-set statistic, and the
    AUC of accept rate against false accepts.  ``accept_if_geq``: accept when
    stat >= threshold (margin, coherence) rather than <= (loss)."""
    pool = np.unique(np.concatenate([stat_in, stat_out]))
    grid = np.concatenate([[pool[0] * 0.5], pool, [pool[-1] * 2.0]])
    rows = []
    for thr in grid:
        acc_in = stat_in >= thr if accept_if_geq else stat_in <= thr
        acc_out = stat_out >= thr if accept_if_geq else stat_out <= thr
        rows.append({"threshold": float(thr), "false_reject": float(1.0 - acc_in.mean()),
                     "false_accept": float(acc_out.mean()) if stat_out.size else None})
    auc = None
    if stat_out.size:
        fa = np.asarray([p["false_accept"] for p in rows])
        tp = 1.0 - np.asarray([p["false_reject"] for p in rows])
        order = np.argsort(fa, kind="stable")
        auc = float(np.trapezoid(tp[order], fa[order]))
    return rows, auc


def model_attribution_point(
    registry: Mapping[str, pl.Pipeline],
    held_out: Mapping[str, pl.Pipeline],
    *,
    key_len: int = 32,
    sigma: float = 6.0,
    samples_per_model: int = 20,
    steps: int = 1000,
    n_starts: int = 8,
    seed: int = 100,
    dtype: str = "bfloat16",
    chunk_samples: int = 20,
    calib_frac: float = 0.5,
    threshold_slack: float = 2.0,
    clip_targets: bool = True,
) -> Dict[str, Any]:
    """Solve ``samples_per_model`` images of every registry and held-out
    generator under every registry model (mse loss); report closed-set
    decision accuracy with its Wilson interval, margins, decoded-key accuracy,
    the four open-set sweeps and the raw per-sample arrays.  Every draw comes
    from a generator folded from ``seed``."""
    if not registry:
        raise ValueError("empty registry")
    reg_names = list(registry.keys())
    pipes = {n: _with_basis(p, key_len, sigma) for n, p in registry.items()}
    held = {n: _with_basis(p, key_len, sigma) for n, p in held_out.items()}

    root = fold_in(seed, 0x30DE1)
    targets_list, true_bits, source = [], [], []
    for offset, group in ((0, pipes), (1000, held)):
        for i, name in enumerate(group):
            t, b = _fingerprinted_targets(group[name], fold_in(root, offset + i), samples_per_model,
                                          clip_targets)
            targets_list.append(t)
            true_bits.append(b)
            source += [name] * samples_per_model
    targets = np.concatenate(targets_list)
    true_bits = np.concatenate(true_bits)  # [S_total, K]
    source = np.asarray(source)
    s_total = targets.shape[0]

    acfg = AttributionConfig(steps=steps, n_starts=n_starts, loss="mse")
    losses_chunks, bits_chunks, best_chunks, coh_chunks = [], [], [], []
    chunk = chunk_samples or s_total
    for c0 in range(0, s_total, chunk):
        res = attribute_model(pipes, torch.from_numpy(targets[c0:c0 + chunk]), fold_in(root, 0xC0 + c0), acfg,
                              dtype=dtype)
        losses_chunks.append(res.losses)  # [M, chunk]
        bits_chunks.append(res.key_bits)
        best_chunks.append(res.best_model)
        coh_chunks.append(res.coherence)  # [M, chunk]
    losses = np.concatenate(losses_chunks, axis=1)  # [M, S_total]
    key_bits = np.concatenate(bits_chunks)  # [S_total, K]
    best = np.concatenate(best_chunks)  # [S_total]
    coherence = np.concatenate(coh_chunks, axis=1)  # [M, S_total]
    best_loss = losses[best, np.arange(s_total)]
    coh_best = coherence[best, np.arange(s_total)]  # [S_total]
    part = np.sort(losses, axis=0)
    margin = part[1] / np.maximum(part[0], 1e-30)

    in_dist = np.isin(source, reg_names)
    calib_mask = np.zeros(s_total, bool)
    for name in reg_names:
        idx = np.where(source == name)[0]
        calib_mask[idx[: max(1, int(len(idx) * calib_frac))]] = True
    eval_in = in_dist & ~calib_mask
    out_dist = ~in_dist

    threshold = calibrate_open_set_threshold(best_loss[calib_mask], percentile=99.0, slack=threshold_slack)

    name_to_idx = {n: i for i, n in enumerate(reg_names)}
    true_idx = np.asarray([name_to_idx.get(s, -1) for s in source])
    correct = (best == true_idx) & eval_in
    n_eval = int(eval_in.sum())
    k_correct = int(correct.sum())
    lo, hi = wilson_ci(k_correct, n_eval)
    key_acc = float((key_bits[correct] == true_bits[correct]).mean()) if correct.any() else None

    fr_at_thr = float((best_loss[eval_in] > threshold).mean())
    fa_at_thr = float((best_loss[out_dist] <= threshold).mean()) if out_dist.any() else None

    # 1: the best loss; 2: the margin (runner-up / best), scale-free; 3: restart
    # coherence of the chosen model's solve; 4: margin x coherence.  Coherence is
    # NaN with fewer than 2 voting restarts, and then 3 and 4 are left out
    sweep, auc = _openset_sweep(best_loss[eval_in], best_loss[out_dist], accept_if_geq=False)
    margin_sweep, margin_auc = _openset_sweep(margin[eval_in], margin[out_dist], accept_if_geq=True)
    coh_valid = not (np.isnan(coh_best[eval_in]).any() or np.isnan(coh_best[out_dist]).any())
    if coh_valid:
        coh_sweep, coh_auc = _openset_sweep(coh_best[eval_in], coh_best[out_dist], accept_if_geq=True)
        combined = margin * coh_best
        comb_sweep, comb_auc = _openset_sweep(combined[eval_in], combined[out_dist], accept_if_geq=True)
    else:
        coh_sweep = coh_auc = comb_sweep = comb_auc = None

    per_model: List[Dict[str, Any]] = []
    for i, name in enumerate(reg_names):
        own = (source == name) & eval_in
        per_model.append({
            "model": name,
            "n_eval": int(own.sum()),
            "decision_acc": float((best[own] == i).mean()) if own.any() else None,
            "own_loss_mean": float(losses[i, own].mean()) if own.any() else None,
            "cross_loss_mean": (float(np.delete(losses[:, own], i, axis=0).mean())
                                if own.any() and len(reg_names) > 1 else None),
            "margin_median": float(np.median(margin[own])) if own.any() else None,
        })

    return {
        "registry": reg_names,
        "held_out": list(held.keys()),
        "key_len": key_len,
        "sigma": float(sigma),
        "samples_per_model": samples_per_model,
        "steps": steps,
        "n_starts": n_starts,
        "n_eval_in_dist": n_eval,
        "decision_acc": k_correct / n_eval if n_eval else None,
        "decision_acc_ci95": [lo, hi],
        "decision_correct_k": k_correct,
        "key_bit_acc_when_decided": key_acc,
        "margin_median_in_dist": float(np.median(margin[eval_in])),
        "margin_min_in_dist": float(margin[eval_in].min()),
        "margin_median_out_dist": float(np.median(margin[out_dist])) if out_dist.any() else None,
        "open_set_threshold": threshold,
        "false_reject_at_threshold": fr_at_thr,
        "false_accept_at_threshold": fa_at_thr,
        "separation_ratio": (float(best_loss[out_dist].min() / max(best_loss[eval_in].max(), 1e-30))
                             if out_dist.any() else None),
        "open_set_auc": auc,
        "open_set_sweep": sweep,
        "margin_open_set_auc": margin_auc,
        "margin_open_set_sweep": margin_sweep,
        "coherence_median_in_dist": float(np.median(coh_best[eval_in])) if coh_valid else None,
        "coherence_median_out_dist": (float(np.median(coh_best[out_dist]))
                                      if coh_valid and out_dist.any() else None),
        "coherence_open_set_auc": coh_auc,
        "coherence_open_set_sweep": coh_sweep,
        "combined_open_set_auc": comb_auc,
        "combined_open_set_sweep": comb_sweep,
        "per_model": per_model,
        # the per-sample arrays, so that another statistic can be read from the record later
        "raw": {
            "source": source.tolist(),
            "registry_idx": true_idx.tolist(),
            "calib_mask": calib_mask.astype(int).tolist(),
            "losses": np.asarray(losses, np.float64).tolist(),
            "margin": np.asarray(margin, np.float64).tolist(),
            "coherence": np.asarray(coherence, np.float64).tolist(),
            "best_model": best.tolist(),
        },
    }
