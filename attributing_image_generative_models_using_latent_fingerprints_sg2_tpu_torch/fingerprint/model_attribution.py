"""Model-level attribution: WHICH registered generator made this image, if any?

Counterpart of the reference package's ``fingerprint/model_attribution.py``.
The solve under one generator attributes an image to a key; over a registry
of fingerprinted generators the same solve, run under every model, gives the
decision statistic: the best restart's final reconstruction loss.  An image
from generator G lies on G's fingerprinted manifold, so the solve under G
reaches about the residual floor, while under another generator it stops at
that generator's projection distance.  The decision is the minimum loss,
with an open-set threshold above which no registered model is named.

A registry may mix families (StyleGAN2 and BigGAN) when every pipeline has
the same ``key_len`` and image size; each model solves with its own family
arguments (``pipeline.solver_kwargs``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

from ..config import AttributionConfig
from ..utils.lhs import fold_in
from . import attribute as attr_mod
from .pipeline import Pipeline, solver_kwargs


@dataclasses.dataclass
class ModelAttributionResult:
    """Per-sample decision over a model registry (host arrays)."""

    model_names: List[str]
    losses: np.ndarray  # [M, S] best-restart final loss under each model
    best_model: np.ndarray  # [S] argmin index
    decided: np.ndarray  # [S] bool: best loss <= open_set_threshold
    margin: np.ndarray  # [S] runner-up loss / best loss (>= 1; inf if M == 1)
    key_bits: np.ndarray  # [S, K] decoded under the chosen model
    results: Dict[str, attr_mod.AttributionResult]  # every model's solve
    # [M, S] restart-key coherence of each solve (restart_coherence): ~1 when the
    # restarts decode one key (the image is this model's), near the noise floor
    # of independent votes when they do not
    coherence: Optional[np.ndarray] = None

    def chosen(self, s: int) -> Optional[str]:
        """Model name for sample ``s``, or None if rejected (open set)."""
        return self.model_names[int(self.best_model[s])] if self.decided[s] else None


def restart_coherence(key_logits_all: np.ndarray, losses_all: np.ndarray, *,
                      top_frac: float = 0.5) -> np.ndarray:
    """Per-sample agreement of the keys that independent restarts decode.

    ``key_logits_all`` [S, n, K], ``losses_all`` [S, n].  The best
    ``top_frac`` of the restarts by final loss vote with the signs of their
    logits; the result is the mean over key positions of |mean vote| in
    [0, 1]: ~1 when the image is this model's (every good restart finds the
    same fingerprint), near E|mean of r random signs| (0.375 at r = 4)
    otherwise.  With fewer than 2 voters the vote is 1 for any image, so the
    statistic says nothing: NaN per sample."""
    logits = np.asarray(key_logits_all, np.float32)
    losses = np.asarray(losses_all, np.float32)
    s, n, _ = logits.shape
    r = max(1, int(np.ceil(n * top_frac)))
    if r < 2:
        return np.full(s, np.nan, np.float32)
    order = np.argsort(losses, axis=1)[:, :r]  # [S, r] best restarts
    picked = np.take_along_axis(logits, order[:, :, None], axis=1)
    votes = np.where(picked > 0.0, 1.0, -1.0)  # [S, r, K]
    return np.abs(votes.mean(axis=1)).mean(axis=-1)  # [S]


def attribute_model(
    pipes: Mapping[str, Pipeline],
    targets: torch.Tensor,
    generator: Optional[torch.Generator],
    acfg: AttributionConfig,
    *,
    open_set_threshold: float = float("inf"),
    alpha_inits: Optional[Mapping[str, torch.Tensor]] = None,
    **attribute_kwargs: Any,
) -> ModelAttributionResult:
    """Solve ``targets`` [S, H, W, 3] under every registered pipeline; decide
    by the minimum best-restart loss.

    Model ``i`` draws its restarts from ``fold_in(generator, i)``, or starts
    from ``alpha_inits[name]`` ([S, n, D-K]) where given.  A sample whose
    best loss exceeds ``open_set_threshold`` is attributed to no registered
    model (default inf: closed set; ``calibrate_open_set_threshold`` sets it
    from in-distribution solves).  ``attribute_kwargs`` (``attack_cfg``,
    ``n_starts``, ``dtype``, ``remat`` ...) go to every solve unchanged."""
    if not pipes:
        raise ValueError("empty model registry")
    names = list(pipes.keys())
    # fail before any solve: key_len decides the shape of the stacked results,
    # img_size whether the model can render the targets at all
    hw_t = tuple(targets.shape[-3:-1])
    k0 = pipes[names[0]].fpcfg.key_len
    for name in names:
        p = pipes[name]
        if p.fpcfg.key_len != k0:
            raise ValueError(f"registry pipelines disagree on key_len: {name!r} has {p.fpcfg.key_len}, "
                             f"{names[0]!r} has {k0}")
        hw = p.mcfg.img_size
        if (hw, hw) != hw_t:
            raise ValueError(f"pipeline {name!r} img_size {hw} != target spatial shape {hw_t}")
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    losses, coherences = [], []
    results: Dict[str, attr_mod.AttributionResult] = {}
    for i, name in enumerate(names):
        pipe = pipes[name]
        res = attr_mod.attribute(
            pipe.gen_params, pipe.lpips_params, pipe.basis, pipe.noise, targets.to(pipe.device),
            mcfg=pipe.mcfg, acfg=acfg, generator=fold_in(generator, i),
            alpha_init=None if alpha_inits is None else alpha_inits[name],
            **solver_kwargs(pipe), **attribute_kwargs)
        results[name] = res
        losses.append(res.loss.cpu().numpy())
        coherences.append(restart_coherence(res.key_logits_all.cpu().numpy(), res.losses_all.cpu().numpy()))
    losses = np.stack(losses)  # [M, S]
    coherence = np.stack(coherences)  # [M, S]
    best = losses.argmin(axis=0)  # [S]
    s_idx = np.arange(losses.shape[1])
    best_loss = losses[best, s_idx]
    if losses.shape[0] > 1:
        part = np.sort(losses, axis=0)
        margin = part[1] / np.maximum(part[0], 1e-30)
    else:
        margin = np.full(losses.shape[1], np.inf)
    key_bits = np.stack([results[names[int(best[s])]].key_bits[s].cpu().numpy() for s in s_idx])
    return ModelAttributionResult(model_names=names, losses=losses, best_model=best,
                                  decided=best_loss <= open_set_threshold, margin=margin, key_bits=key_bits,
                                  results=results, coherence=coherence)


def calibrate_open_set_threshold(in_dist_losses: np.ndarray, percentile: float = 99.0,
                                 slack: float = 2.0) -> float:
    """Threshold from solves on images the registered models did generate:
    the ``percentile`` of their losses times ``slack``, so borderline
    in-distribution samples pass and out-of-registry images are rejected."""
    losses = np.asarray(in_dist_losses, np.float64).reshape(-1)
    if losses.size == 0:
        raise ValueError("need at least one in-distribution loss")
    return float(np.percentile(losses, percentile) * slack)
