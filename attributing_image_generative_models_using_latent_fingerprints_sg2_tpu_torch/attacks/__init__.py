"""Robustness attacks as plain functions on NHWC tensors in [-1, 1]
(the reference package's ``attacks/``).

``make_attack(cfg, is_train)`` builds ``(img, generator=None, noise=None) ->
img`` for the targets.  Eval mode (``is_train=False``) applies the strongest
setting of each attack deterministically; train mode draws the strengths:
Blur a filter size from (3, 5, blur_filter_size)
(:func:`blur.gaussian_blur_random`), Crop a window offset
(:func:`crop.random_crop`), Jpeg rounds differentiably, and Combination
applies each member with probability 0.5.  ``make_solver_attack`` builds the
deterministic, differentiable channel model that attack-aware solving pushes
its estimate through.  Random draws come from an explicit
``torch.Generator`` on the CPU; Noise also takes the unit-normal ``noise``
array itself, and the train-mode functions take their drawn index or offset.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..config import AttackConfig
from .blur import gaussian_blur, gaussian_blur_random
from .crop import center_crop, random_crop
from .diffjpeg import diff_round, jpeg_attack, jpeg_compress_decompress, quality_to_factor  # noqa: F401
from .noise import gaussian_noise

AttackFn = Callable[..., torch.Tensor]


def make_attack(cfg: AttackConfig, is_train: bool = False) -> Optional[AttackFn]:
    """``(img, generator=None, noise=None) -> img`` for cfg.augmentation; None for "None"."""
    name = cfg.augmentation
    if name == "None":
        return None
    if name == "Noise":
        return lambda img, generator=None, noise=None: gaussian_noise(img, generator, cfg.noise_sigma, noise)
    if name == "Blur":
        if is_train:
            return lambda img, generator=None, noise=None: gaussian_blur_random(
                img, generator, (cfg.blur_sigma,), (3, 5, cfg.blur_filter_size))
        return lambda img, generator=None, noise=None: gaussian_blur(img, cfg.blur_sigma, cfg.blur_filter_size)
    if name == "Crop":
        if is_train:
            return lambda img, generator=None, noise=None: random_crop(img, generator, cfg.crop_ratio)
        return lambda img, generator=None, noise=None: center_crop(img, cfg.crop_ratio)
    if name == "Jpeg":
        return lambda img, generator=None, noise=None: jpeg_attack(img, cfg.jpeg_quality, differentiable=is_train)
    if name == "Combination":
        # blur, then noise, then JPEG: in eval mode every member applies, in train
        # mode each with probability 0.5 (three uniforms drawn before the noise)
        def fn(img, generator=None, noise=None):
            apply = [True] * 3
            if is_train:
                g = generator if generator is not None else torch.Generator().manual_seed(0)
                apply = [bool(p > 0.5) for p in torch.rand(3, generator=g)]
                generator = g
            if apply[0]:
                img = gaussian_blur(img, cfg.blur_sigma, cfg.blur_filter_size)
            if apply[1]:
                img = gaussian_noise(img, generator, cfg.noise_sigma, noise)
            if apply[2]:
                img = jpeg_attack(img, cfg.jpeg_quality, differentiable=is_train)
            return img

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
