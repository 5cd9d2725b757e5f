"""Crop attack (the reference package's ``attacks/crop.py``, eval mode): the
centre window of ``ratio`` x the image, resized back bilinearly (half-pixel
centres, no antialiasing: it is an upscale)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def center_crop(img: torch.Tensor, ratio: float = 0.9) -> torch.Tensor:
    _, h, w, _ = img.shape
    ch, cw = max(1, int(h * ratio)), max(1, int(w * ratio))
    y0, x0 = (h - ch) // 2, (w - cw) // 2
    patch = img[:, y0:y0 + ch, x0:x0 + cw].permute(0, 3, 1, 2)
    out = F.interpolate(patch, size=(h, w), mode="bilinear", align_corners=False, antialias=False)
    return out.permute(0, 2, 3, 1)
