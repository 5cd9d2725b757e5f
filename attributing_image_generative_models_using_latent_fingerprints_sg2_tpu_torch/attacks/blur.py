"""Gaussian blur attack (the reference package's ``attacks/blur.py``, eval
mode): torchvision ``GaussianBlur`` semantics, 1-D kernel
k[i] = exp(-(i - (n-1)/2)^2 / (2 s^2)) normalized, applied separably with
reflect padding as two depthwise convolutions on NHWC."""

from __future__ import annotations

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
