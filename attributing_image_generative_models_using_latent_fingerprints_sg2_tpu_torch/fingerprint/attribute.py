"""Gradient-based attribution: invert images back to (alpha, key).

Counterpart of the reference package's ``fingerprint/attribute.py``
(``attribute`` without pruning, polish, coarse-to-fine or the solver
attack).  Per target and per Latin-Hypercube restart it solves

    min_{alpha, key}  loss(target, G(w(alpha, sigmoid(key)))) + 0.1 * bound(alpha)

with all S samples x n restarts flattened into one generator batch: Adam is
elementwise and the loss is per element, so one update over [S, n, ...]
tensors is S*n independent chains.  Target LPIPS features are extracted
once, normalized, and held constant.

Adam is written out: b1=0.9, b2=0.999, eps=1e-8 outside the sqrt, bias
correction by count+1, rate lr * exp(-decay * (count+1)) with count from 0
(the reference's optax chain).  The reported per-restart loss is the last
step's PRE-update loss; the returned alpha/key are the POST-update state.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..config import AttributionConfig, ModelConfig
from ..losses import lpips as lpips_mod
from ..models import stylegan2 as sg2
from ..utils.lhs import lhs_alpha_init_batch
from .embed import FingerprintBasis, alpha_bound_penalty, bit_accuracy, content_latent, key_offset

B1, B2, EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass
class AttributionResult:
    alpha: torch.Tensor  # [S, D-K] best restart's content coefficients
    key_logits: torch.Tensor  # [S, K]
    key_bits: torch.Tensor  # [S, K] in {0, 1}
    loss: torch.Tensor  # [S] best final (pre-update) loss
    losses_all: torch.Tensor  # [S, n] final loss of every restart
    best_start: torch.Tensor  # [S] argmin restart index


def make_attribution_step(
    gen_params, lpips_params, basis: FingerprintBasis, noise, mcfg: ModelConfig,
    acfg: AttributionConfig, target_feats, targets,
) -> Tuple[Callable, Callable]:
    """(step, per_elem_loss) for [S, n] restarts.

    ``target_feats``: list of [S, 1, h, w, c] normalized features
    (perceptual) or None; ``targets``: [S, 1, H, W, 3] images (mse) or None.
    ``step(state) -> (state, per)`` does one loss + grad + Adam update on
    ``state = {"alpha", "key", "m_alpha", "v_alpha", "m_key", "v_key", "count"}``
    and returns the pre-update per-element loss [S, n].
    """
    nl = mcfg.n_latent

    def per_elem_loss(alpha: torch.Tensor, key_logits: torch.Tensor) -> torch.Tensor:
        s_, n_ = alpha.shape[0], alpha.shape[1]
        k = torch.sigmoid(key_logits)
        wx = content_latent(basis, alpha.reshape(s_ * n_, -1)) + key_offset(basis, k.reshape(s_ * n_, -1))
        wplus = wx[:, None, :].expand(-1, nl, -1)
        imgs = sg2.synthesis(gen_params, wplus, noise, blur_kernel=mcfg.blur_kernel)
        if acfg.loss == "perceptual":
            feats = lpips_mod.extract_raw_features(lpips_params, imgs)
            feats = [f.reshape((s_, n_) + tuple(f.shape[1:])) for f in feats]
            per = lpips_mod.distance_from_raw_features(lpips_params, feats, target_feats)
        else:
            est = imgs.reshape((s_, n_) + tuple(imgs.shape[1:]))
            per = torch.mean((est - targets) ** 2, dim=(-3, -2, -1))
        return per + acfg.bound_weight * alpha_bound_penalty(basis, alpha)

    def step(state: Dict[str, Any]) -> Tuple[Dict[str, Any], torch.Tensor]:
        alpha = state["alpha"].detach().requires_grad_(True)
        key = state["key"].detach().requires_grad_(True)
        with torch.enable_grad():
            per = per_elem_loss(alpha, key)
            g_alpha, g_key = torch.autograd.grad(per.sum(), [alpha, key])
        return adam_update(state, {"alpha": g_alpha, "key": g_key}, acfg), per.detach()

    return step, per_elem_loss


@torch.no_grad()
def adam_update(state: Dict[str, Any], grads: Dict[str, torch.Tensor],
                acfg: AttributionConfig) -> Dict[str, Any]:
    """One Adam step (the reference's optax chain, written out) on
    ``state["alpha"]`` and ``state["key"]``; returns the new state."""
    t = state["count"] + 1
    lr = acfg.lr * math.exp(-acfg.lr_decay * t)
    new = {"count": t}
    for name, g in grads.items():
        m = state["m_" + name] * B1 + (1.0 - B1) * g
        v = state["v_" + name] * B2 + (1.0 - B2) * g * g
        m_hat = m / (1.0 - B1 ** t)
        v_hat = v / (1.0 - B2 ** t)
        new[name] = state[name].detach() - lr * (m_hat / (torch.sqrt(v_hat) + EPS))
        new["m_" + name], new["v_" + name] = m, v
    return new


def init_state(alpha0: torch.Tensor, key0: torch.Tensor) -> Dict[str, Any]:
    z = torch.zeros_like
    return {"alpha": alpha0, "key": key0, "m_alpha": z(alpha0), "v_alpha": z(alpha0),
            "m_key": z(key0), "v_key": z(key0), "count": 0}


def attribute(
    gen_params, lpips_params, basis: FingerprintBasis, noise,
    targets: torch.Tensor,  # [S, H, W, 3] in [-1, 1]
    *,
    mcfg: ModelConfig,
    acfg: AttributionConfig,
    generator: Optional[torch.Generator] = None,
    alpha_init: Optional[torch.Tensor] = None,
    key_init: Optional[torch.Tensor] = None,
) -> AttributionResult:
    """Solve attribution for a batch of targets, all samples x restarts at once.

    ``alpha_init`` / ``key_init`` ([S, n, D-K] / [S, n, K]) replace the
    centered-LHS / zero restart initialization (drawn from ``generator``)."""
    n_starts = acfg.n_starts
    device = targets.device
    s_ = targets.shape[0]
    if alpha_init is None:
        alpha_init = lhs_alpha_init_batch(s_, n_starts, basis.sigma_rest, generator)
    if key_init is None:
        key_init = torch.zeros((s_, n_starts, basis.v_cap.shape[0]))
    alpha0 = torch.as_tensor(alpha_init, dtype=torch.float32).to(device)
    key0 = torch.as_tensor(key_init, dtype=torch.float32).to(device)

    with torch.no_grad():
        if acfg.loss == "perceptual":
            target_feats = [f[:, None] for f in lpips_mod.extract_features(lpips_params, targets)]
            tgt = None
        elif acfg.loss == "mse":
            target_feats, tgt = None, targets[:, None]
        else:
            raise ValueError(f"loss must be 'perceptual' or 'mse', got {acfg.loss!r}")

    step, _ = make_attribution_step(gen_params, lpips_params, basis, noise, mcfg, acfg,
                                    target_feats, tgt)
    state = init_state(alpha0, key0)
    per = None
    for _ in range(acfg.steps):
        state, per = step(state)
    final_per = per  # [S, n] pre-update loss of the last step
    best = torch.argmin(final_per, dim=1)
    rows = torch.arange(s_, device=device)
    key_best = state["key"][rows, best]
    return AttributionResult(
        alpha=state["alpha"][rows, best],
        key_logits=key_best,
        key_bits=torch.round(torch.sigmoid(key_best)),
        loss=final_per[rows, best],
        losses_all=final_per,
        best_start=best,
    )


def evaluate_attribution(result: AttributionResult, true_keys: torch.Tensor) -> Dict[str, Any]:
    """Per-sample bit accuracy and exact-match attribution accuracy."""
    acc = bit_accuracy(result.key_bits, true_keys.to(result.key_bits.device))
    exact = (acc >= 1.0).float()
    return {"bit_acc": acc, "mean_bit_acc": acc.mean(), "attribution_acc": exact.mean(),
            "exact": exact}
