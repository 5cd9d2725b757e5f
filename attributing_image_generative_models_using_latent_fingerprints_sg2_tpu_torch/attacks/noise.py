"""Additive Gaussian noise attack: image + N(0, std^2), clamped to [-1, 1]
(the reference package's ``attacks/noise.py``)."""

from __future__ import annotations

from typing import Optional

import torch


def gaussian_noise(img: torch.Tensor, generator: Optional[torch.Generator] = None, std: float = 0.1,
                   noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``noise``, where given, is the unit-normal draw of ``img``'s shape;
    else it is drawn on the CPU from ``generator`` (seed 0 when None), so a
    seed gives the same noise on every device."""
    if noise is None:
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        noise = torch.randn(img.shape, generator=g, dtype=img.dtype)
    return torch.clamp(img + std * noise.to(img.device, img.dtype), -1.0, 1.0)
