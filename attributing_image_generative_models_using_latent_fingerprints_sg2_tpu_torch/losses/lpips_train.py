"""LPIPS training and evaluation: the 2AFC ranking head, its loss, the 2AFC /
JND scores, and fitting the lin heads on triplets.

Counterpart of the reference package's ``losses/lpips_train.py`` (the
reference's ``Dist2LogitLayer`` + ``BCERankingLoss`` and the scoring of
``dist_model.py``).  The backbone stays frozen: the lin heads and the ranking
head are the only parameters trained.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.tree import tree_leaves

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, 0.2 * x)


def init_dist2logit_params(generator: Optional[torch.Generator], device, chn_mid: int = 32) -> Dict[str, Any]:
    """Three linear layers 5 -> chn_mid -> chn_mid -> 1, weights N(0, 1/cin),
    zero biases, drawn on the CPU from ``generator`` and moved to ``device``."""
    def lin(cin, cout):
        w = torch.randn((cin, cout), generator=generator) * (1.0 / math.sqrt(cin))
        return {"w": w.to(device), "b": torch.zeros((cout,), device=device)}

    return {"l1": lin(5, chn_mid), "l2": lin(chn_mid, chn_mid), "l3": lin(chn_mid, 1)}


def dist2logit(params: Dict[str, Any], d0: torch.Tensor, d1: torch.Tensor, eps: float = 0.1) -> torch.Tensor:
    """[B] distances d0, d1 -> [B] probability that p1 is the closer one:
    (d0, d1, d0 - d1, d0 / (d1 + eps), d1 / (d0 + eps)) through two linear +
    leaky ReLU layers and a linear one, then a sigmoid."""
    f = torch.stack([d0, d1, d0 - d1, d0 / (d1 + eps), d1 / (d0 + eps)], dim=-1)
    h = _leaky(f @ params["l1"]["w"] + params["l1"]["b"])
    h = _leaky(h @ params["l2"]["w"] + params["l2"]["b"])
    return torch.sigmoid((h @ params["l3"]["w"] + params["l3"]["b"])[..., 0])


def bce_ranking_loss(params: Dict[str, Any], d0: torch.Tensor, d1: torch.Tensor,
                     judge: torch.Tensor) -> torch.Tensor:
    """BCE of the ranking head's probability against per = (judge + 1) / 2
    (judge in [-1, 1], +1: p1 is closer)."""
    per = (judge + 1.0) / 2.0
    p = torch.clamp(dist2logit(params, d0, d1), 1e-7, 1 - 1e-7)
    return -torch.mean(per * torch.log(p) + (1.0 - per) * torch.log(1.0 - p))


def score_2afc(d0s, d1s, gts) -> float:
    """Agreement with judges: ``gts`` is the fraction who picked p1; the metric
    picks the smaller distance (a tie scores 0.5)."""
    d0s, d1s, gts = map(np.asarray, (d0s, d1s, gts))
    scores = (d0s < d1s) * (1 - gts) + (d1s < d0s) * gts + (d1s == d0s) * 0.5
    return float(np.mean(scores))


def score_jnd(ds, sames) -> float:
    """mAP of "same" detection by thresholding distances (11-point VOC AP)."""
    ds, sames = np.asarray(ds), np.asarray(sames, np.float64)
    order = np.argsort(ds)
    sames_sorted = sames[order]
    tps = np.cumsum(sames_sorted)
    fps = np.cumsum(1 - sames_sorted)
    fns = np.sum(sames_sorted) - tps
    precs = tps / np.maximum(tps + fps, 1e-12)
    recs = tps / np.maximum(tps + fns, 1e-12)
    ap = 0.0
    for t in np.linspace(0, 1, 11):
        p = precs[recs >= t]
        ap += (p.max() if p.size else 0.0) / 11.0
    return float(ap)


def train_lin_heads(
    lpips_params: Dict[str, Any],
    batches,  # dicts of ref, p0, p1 [B, H, W, 3] and judge [B]
    steps: int = 100,
    lr: float = 1e-3,
    generator: Optional[torch.Generator] = None,
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Fit the lin heads and the ranking head on 2AFC triplets, cycling
    through ``batches``: the BCE ranking loss of the two LPIPS distances, Adam
    as optax computes it, the heads projected to >= 0 after each step.  The
    backbone's features are taken once a step with no gradient; only the heads
    and the ranking net are differentiated.  The ranking head starts from
    :func:`init_dist2logit_params` drawn from ``generator`` (seed 0 when
    None).  Returns ``(lpips_params with the fitted heads, ranking params)``."""
    from . import lpips as lpips_mod

    batches = list(batches)
    device = tree_leaves(lpips_params["lin"])[0].device
    rank = init_dist2logit_params(generator if generator is not None else torch.Generator().manual_seed(0), device)
    leaves = [p.detach().clone() for p in list(lpips_params["lin"]) + [rank[k][n] for k in ("l1", "l2", "l3")
                                                                        for n in ("w", "b")]]
    n_lin = len(lpips_params["lin"])
    m = [torch.zeros_like(p) for p in leaves]
    v = [torch.zeros_like(p) for p in leaves]
    for t in range(1, steps + 1):
        b = batches[(t - 1) % len(batches)]
        with torch.no_grad():
            fr, f0, f1 = (lpips_mod.extract_features(lpips_params, b[k]) for k in ("ref", "p0", "p1"))
        ps = [p.detach().requires_grad_(True) for p in leaves]
        lp = dict(lpips_params, lin=ps[:n_lin])
        rk = {k: {"w": ps[n_lin + 2 * i], "b": ps[n_lin + 2 * i + 1]} for i, k in enumerate(("l1", "l2", "l3"))}
        with torch.enable_grad():
            loss = bce_ranking_loss(rk, lpips_mod.distance_from_features(lp, fr, f0),
                                    lpips_mod.distance_from_features(lp, fr, f1), b["judge"])
            grads = torch.autograd.grad(loss, ps)
        with torch.no_grad():
            for i, g in enumerate(grads):
                m[i] = ADAM_B1 * m[i] + (1.0 - ADAM_B1) * g
                v[i] = ADAM_B2 * v[i] + (1.0 - ADAM_B2) * g * g
                m_hat = m[i] / (1.0 - ADAM_B1 ** t)
                v_hat = v[i] / (1.0 - ADAM_B2 ** t)
                leaves[i] = leaves[i] - lr * m_hat / (torch.sqrt(v_hat) + ADAM_EPS)
            for i in range(n_lin):
                leaves[i] = torch.clamp(leaves[i], min=0.0)
    rank = {k: {"w": leaves[n_lin + 2 * i], "b": leaves[n_lin + 2 * i + 1]} for i, k in enumerate(("l1", "l2", "l3"))}
    return dict(lpips_params, lin=leaves[:n_lin]), rank


def save_lin_weights(path: str, lin) -> None:
    """The lin heads as a portable ``.npz`` (``lin0`` .. ``linK``)."""
    np.savez(path, **{f"lin{k}": np.asarray(w.detach().cpu().numpy() if torch.is_tensor(w) else w)
                      for k, w in enumerate(lin)})


def load_lin_weights(path: str, device="cuda") -> List[torch.Tensor]:
    """Inverse of :func:`save_lin_weights`: float32 [C] tensors on ``device``,
    the card unless the caller asks for ``"cpu"``."""
    device = resolve_device(device)
    with np.load(path) as z:
        return [torch.from_numpy(np.asarray(z[f"lin{k}"], np.float32)).to(device) for k in range(len(z.files))]
