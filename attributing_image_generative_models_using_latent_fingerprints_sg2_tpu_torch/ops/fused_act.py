"""Fused bias + LeakyReLU: ``scale * leaky_relu(x + bias)``, slope 0.2, scale sqrt(2).

Counterpart of the reference's ``ops/fused_act.py``; the bias broadcasts over
the last (channel) axis of NHWC input.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

SQRT2 = math.sqrt(2.0)


def fused_leaky_relu(
    x: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    negative_slope: float = 0.2,
    scale: float = SQRT2,
) -> torch.Tensor:
    if bias is not None:
        x = x + bias
    return torch.where(x >= 0, x, negative_slope * x) * scale
