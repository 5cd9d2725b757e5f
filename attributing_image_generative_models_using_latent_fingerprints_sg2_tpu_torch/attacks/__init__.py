"""Robustness attacks as plain functions on NHWC tensors in [-1, 1]
(the reference package's ``attacks/``, eval mode: the strongest setting of
each attack, applied deterministically; the train-mode random strengths
belong to GAN training and are not ported).

``make_attack`` builds ``(img, generator=None, noise=None) -> img`` for the
targets; ``make_solver_attack`` the deterministic, differentiable channel
model that attack-aware solving pushes its estimate through.  Random
attacks (Noise, Combination) draw from an explicit ``torch.Generator`` on
the CPU, or take the unit-normal ``noise`` array itself.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..config import AttackConfig
from .blur import gaussian_blur
from .crop import center_crop
from .diffjpeg import diff_round, jpeg_attack, jpeg_compress_decompress, quality_to_factor  # noqa: F401
from .noise import gaussian_noise

AttackFn = Callable[..., torch.Tensor]


def make_attack(cfg: AttackConfig) -> Optional[AttackFn]:
    """``(img, generator=None, noise=None) -> img`` for cfg.augmentation; None for "None"."""
    name = cfg.augmentation
    if name == "None":
        return None
    if name == "Noise":
        return lambda img, generator=None, noise=None: gaussian_noise(img, generator, cfg.noise_sigma, noise)
    if name == "Blur":
        return lambda img, generator=None, noise=None: gaussian_blur(img, cfg.blur_sigma, cfg.blur_filter_size)
    if name == "Crop":
        return lambda img, generator=None, noise=None: center_crop(img, cfg.crop_ratio)
    if name == "Jpeg":
        return lambda img, generator=None, noise=None: jpeg_attack(img, cfg.jpeg_quality, differentiable=False)
    if name == "Combination":
        # every member applies in eval mode: blur, then noise, then hard-rounded JPEG
        def fn(img, generator=None, noise=None):
            img = gaussian_blur(img, cfg.blur_sigma, cfg.blur_filter_size)
            img = gaussian_noise(img, generator, cfg.noise_sigma, noise)
            return jpeg_attack(img, cfg.jpeg_quality, differentiable=False)

        return fn
    raise ValueError(f"Not available attack: {name!r}")


def make_solver_attack(cfg: AttackConfig, name: str) -> Optional[Callable[[torch.Tensor], torch.Tensor]]:
    """The channel model of attack ``name`` for attack-aware attribution:
    shape-preserving, free of random draws, differentiable.  Jpeg rounds
    differentiably (hard rounding has zero gradient almost everywhere);
    Noise is the identity (zero-mean: the attacked target is an unbiased
    observation); Combination composes its deterministic members."""
    if name == "None":
        return None
    if name == "Noise":
        return lambda img: img
    if name == "Blur":
        return lambda img: gaussian_blur(img, cfg.blur_sigma, cfg.blur_filter_size)
    if name == "Crop":
        return lambda img: center_crop(img, cfg.crop_ratio)
    if name == "Jpeg":
        return lambda img: jpeg_attack(img, cfg.jpeg_quality, differentiable=True)
    if name == "Combination":
        return lambda img: jpeg_attack(gaussian_blur(img, cfg.blur_sigma, cfg.blur_filter_size),
                                       cfg.jpeg_quality, differentiable=True)
    raise ValueError(f"Not available solver attack: {name!r}")


def apply_attack(attack: Optional[AttackFn], img: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The augmentation entry point: the identity when no attack is configured."""
    if attack is None:
        return img
    return attack(img, generator, noise)
