"""Self-supervised 2AFC calibration of the LPIPS lin heads.

Counterpart of the reference package's ``losses/calibrate.py``.  With no
human 2AFC judgements to hand, a graded distortion stands in for the judge:
two versions of one reference image, distorted by one family at two adjacent
strengths; the weaker one is the closer by construction.  Fitting the heads
on such triplets (``losses/lpips_train.py::train_lin_heads``) teaches them
which backbone channels follow perceptual damage, for a random-init VGG or
the trained discriminator (``losses/disc_percept.py``) alike.

The families follow the robustness attacks (``attacks/``): blur sigma,
additive noise, JPEG quality.  Every draw comes from a ``torch.Generator``
(``utils.lhs.fold_in`` per batch and per draw); the images are rendered on
the device of the heads being fitted.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional

import torch

from ..attacks.blur import gaussian_blur
from ..attacks.diffjpeg import jpeg_attack
from ..attacks.noise import gaussian_noise
from ..training.data import sample_batch
from ..utils.lhs import fold_in
from ..utils.tree import tree_leaves

# Strength ladders per family (weak -> strong).  Triplets compare ADJACENT
# rungs: far-apart strengths are separable by any feature stack, so only near
# comparisons carry a training signal for the heads.
_LEVELS = {
    "blur": (0.2, 0.35, 0.6, 1.0, 1.6),
    "noise": (0.03, 0.055, 0.1, 0.16, 0.25),
    "jpeg": (90, 70, 50, 38, 28),  # quality: higher = weaker distortion
}


def _distort(family: str, img: torch.Tensor, strength, generator: Optional[torch.Generator] = None,
             noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``img`` distorted by ``family`` at ``strength``; the noise family draws
    from ``generator`` or takes the unit-normal ``noise``."""
    if family == "blur":
        return gaussian_blur(img, sigma=float(strength), size=13)
    if family == "noise":
        return gaussian_noise(img, generator, std=float(strength), noise=noise)
    if family == "jpeg":
        return jpeg_attack(img, quality=int(strength), differentiable=True)
    raise ValueError(family)


def _device_of(lpips_params: Dict[str, Any]) -> torch.device:
    return tree_leaves(lpips_params["lin"])[0].device


def triplet_batches(
    generator: torch.Generator,
    *,
    batch: int = 8,
    size: int = 64,
    n_batches: int = 60,
    device="cuda",
) -> Iterator[Dict[str, torch.Tensor]]:
    """Procedural-scene 2AFC triplets on ``device``: a reference batch and two
    adjacent rungs of one family's ladder; the judge marks the weaker rung as
    closer (+1: p1 is closer, -1: p0), with p0 / p1 swapped at random so the
    ranking head sees both orders.  Batch i draws from ``fold_in(generator, i)``."""
    fams = list(_LEVELS)
    for i in range(n_batches):
        k = fold_in(generator, i)
        k_img, k_fam, k_lvl, k_n0, k_n1, k_swap = (fold_in(k, j) for j in range(6))
        ref = sample_batch(k_img, batch, size, device=device)
        fam = fams[int(torch.randint(0, len(fams), (), generator=k_fam))]
        ladder = _LEVELS[fam]
        j = int(torch.randint(0, len(ladder) - 1, (), generator=k_lvl))
        weak = torch.clamp(_distort(fam, ref, ladder[j], k_n1), -1, 1)
        strong = torch.clamp(_distort(fam, ref, ladder[j + 1], k_n0), -1, 1)
        ones = torch.ones((batch,), device=ref.device)
        if bool(torch.rand((), generator=k_swap) < 0.5):
            yield {"ref": ref, "p0": weak, "p1": strong, "judge": -ones}
        else:
            yield {"ref": ref, "p0": strong, "p1": weak, "judge": ones}


def calibrate_lin_heads(
    lpips_params: Dict[str, Any],
    *,
    generator: Optional[torch.Generator] = None,
    size: int = 64,
    batch: int = 8,
    steps: int = 120,
    lr: float = 3e-3,
) -> Dict[str, Any]:
    """``lpips_params`` with its lin heads fitted on graded-distortion
    triplets (any backbone the LPIPS head takes: VGG or the discriminator).
    Data from ``fold_in(generator, 0)``, the ranking head from
    ``fold_in(generator, 1)`` (seed 42 when None)."""
    from .lpips_train import train_lin_heads

    g = generator if generator is not None else torch.Generator().manual_seed(42)
    batches = list(triplet_batches(fold_in(g, 0), batch=batch, size=size, n_batches=max(20, steps // 3),
                                   device=_device_of(lpips_params)))
    fitted, _ = train_lin_heads(lpips_params, batches, steps=steps, lr=lr, generator=fold_in(g, 1))
    return fitted


@torch.no_grad()
def rank_accuracy(
    lpips_params: Dict[str, Any],
    *,
    generator: Optional[torch.Generator] = None,
    size: int = 64,
    batch: int = 8,
    n_batches: int = 20,
) -> float:
    """Fraction of held-out triplets (seed 1234 when ``generator`` is None)
    where the metric ranks the weaker distortion closer (0.5 = chance)."""
    from . import lpips as lpips_mod

    g = generator if generator is not None else torch.Generator().manual_seed(1234)
    correct, total = 0, 0
    for b in triplet_batches(g, batch=batch, size=size, n_batches=n_batches, device=_device_of(lpips_params)):
        d0 = lpips_mod.lpips(lpips_params, b["ref"], b["p0"])
        d1 = lpips_mod.lpips(lpips_params, b["ref"], b["p1"])
        pred = torch.where(d1 < d0, 1.0, -1.0)
        correct += int((pred == b["judge"]).sum())
        total += int(b["judge"].shape[0])
    return correct / max(1, total)
