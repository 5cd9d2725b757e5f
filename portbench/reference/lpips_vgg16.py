"""LPIPS-VGG16 (Zhang et al., arXiv:1801.03924) in plain PyTorch: the scaling
layer, VGG16's convs to relu5_3 with 2x2 max pools, the five slices' features
unit-normalized over channels, squared differences weighted by the lin
heads, averaged over space and summed over the slices.  Its gradient is
autograd's, where the port derives the distance's backward by hand."""

from __future__ import annotations

import math
from typing import List

import torch
import torch.nn.functional as F

from .precision import FLOAT32, Precision
from .stylegan2 import _Draw, _fill

VGG16_PLAN = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512)
SLICE_END_CONV = (1, 3, 6, 9, 12)
LPIPS_CHANNELS = (64, 128, 256, 512, 512)
SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)


def make_params(gen: torch.Generator, device) -> dict:
    """Random LPIPS in the port's tree: He-scaled HWIO convs with small biases,
    positive lin heads of mean 1 / C (trained ones are non-negative)."""
    d = _Draw()
    vgg, cin = [], 3
    for cout in (c for c in VGG16_PLAN if c != "M"):
        vgg.append({"weight": d.leaf((3, 3, cin, cout), math.sqrt(2.0 / (9 * cin))), "bias": d.leaf((cout,), 0.05)})
        cin = cout
    lin = [d.leaf((c,), math.sqrt(math.pi / 2) / c, absolute=True) for c in LPIPS_CHANNELS]
    return _fill({"vgg": vgg, "lin": lin}, d.realize(gen, device))


def features(params: dict, img: torch.Tensor, prec: Precision = FLOAT32) -> List[torch.Tensor]:
    """[-1, 1] NHWC images -> the five raw slice outputs, NCHW."""
    x = img.float().permute(0, 3, 1, 2)
    shift = torch.tensor(SHIFT, device=x.device)[None, :, None, None]
    scale = torch.tensor(SCALE, device=x.device)[None, :, None, None]
    x = (x - shift) / scale
    feats, i = [], 0
    for item in VGG16_PLAN:
        if item == "M":
            x = F.max_pool2d(x, 2)
            continue
        p = params["vgg"][i]
        x = F.relu(prec.conv2d(x, p["weight"].permute(3, 2, 0, 1), p["bias"], padding=1))
        if i in SLICE_END_CONV:
            feats.append(x)
        i += 1
    return feats


def normalize(f: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Unit norm over channels; a pixel whose channels are all zero stays zero
    and passes no gradient (``vector_norm``'s subgradient at 0)."""
    return f / (torch.linalg.vector_norm(f, dim=1, keepdim=True) + eps)


def target_features(params: dict, target: torch.Tensor, prec: Precision = FLOAT32) -> List[torch.Tensor]:
    """A target's normalized features [1, C, h, w]."""
    return [normalize(f) for f in features(params, target, prec)]


def distance(params: dict, feats: List[torch.Tensor], tfeats: List[torch.Tensor]) -> torch.Tensor:
    """Per-image distance [B] of raw features against normalized target ones."""
    total = 0.0
    for f, t, lin in zip(feats, tfeats, params["lin"]):
        total = total + torch.mean(torch.sum((normalize(f) - t) ** 2 * lin[None, :, None, None], dim=1), dim=(1, 2))
    return total
