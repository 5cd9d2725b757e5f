"""Gaussian blur attack (the reference package's ``attacks/blur.py``):
torchvision ``GaussianBlur`` semantics, 1-D kernel
k[i] = exp(-(i - (n-1)/2)^2 / (2 s^2)) normalized, applied separably with
reflect padding as two depthwise convolutions on NHWC.

Eval mode blurs at a fixed (size, sigma); train mode
(:func:`gaussian_blur_random`) draws the size (and sigma) per call and runs a
kernel of the largest size whose taps outside the chosen size are zero, which
gives the small kernel's result, since reflect padding reads symmetrically."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F


def gaussian_kernel_1d(size: int, sigma: float) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32) - (size - 1) / 2.0
    k = torch.exp(-(x ** 2) / (2.0 * float(sigma) ** 2))
    return k / k.sum()


def separable_blur(img: torch.Tensor, k: torch.Tensor, pad_mode: str) -> torch.Tensor:
    """Depthwise k (rows) then k (columns) on NHWC, same size out; ``pad_mode``
    is ``"reflect"`` or ``"constant"`` (zeros)."""
    size, pad = k.shape[0], (k.shape[0] - 1) // 2
    c = img.shape[-1]
    x = F.pad(img.permute(0, 3, 1, 2), (pad, pad, pad, pad), mode=pad_mode)
    k = k.to(img.device, img.dtype)
    x = F.conv2d(x, k.view(1, 1, size, 1).expand(c, 1, size, 1), groups=c)
    return F.conv2d(x, k.view(1, 1, 1, size).expand(c, 1, 1, size), groups=c).permute(0, 2, 3, 1)


def gaussian_blur(img: torch.Tensor, sigma: float = 0.5, size: int = 25) -> torch.Tensor:
    return separable_blur(img, gaussian_kernel_1d(size, sigma), "reflect")


def gaussian_blur_random(img: torch.Tensor, generator: Optional[torch.Generator] = None,
                         sigmas: Sequence[float] = (0.5,), sizes: Sequence[int] = (3, 5, 25),
                         choice: Optional[int] = None) -> torch.Tensor:
    """Train-mode blur: size ``sizes[choice]`` with sigma
    ``sigmas[min(choice, len(sigmas) - 1)]``.  ``choice``, where given, is the
    drawn index; else it is drawn uniformly on the CPU from ``generator`` (seed
    0 when None)."""
    if choice is None:
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        choice = int(torch.randint(0, len(sizes), (), generator=g))
    sigma = float(sigmas[min(choice, len(sigmas) - 1)])
    max_size = max(sizes)
    x = torch.arange(max_size, dtype=torch.float32) - (max_size - 1) // 2
    k = torch.exp(-(x ** 2) / (2.0 * sigma ** 2))
    k = torch.where(x.abs() <= (sizes[choice] - 1) / 2.0, k, torch.zeros_like(k))
    return separable_blur(img, k / k.sum(), "reflect")
