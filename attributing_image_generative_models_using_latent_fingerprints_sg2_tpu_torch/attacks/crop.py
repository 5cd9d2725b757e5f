"""Crop attack (the reference package's ``attacks/crop.py``): a window of
``ratio`` x the image, resized back bilinearly (half-pixel centres, no
antialiasing: it is an upscale).  Eval mode takes the centre window; train
mode (:func:`random_crop`) a random offset at the same static size."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def _window(img: torch.Tensor, ratio: float) -> Tuple[int, int]:
    _, h, w, _ = img.shape
    return max(1, int(h * ratio)), max(1, int(w * ratio))


def _crop_resize(img: torch.Tensor, y0: int, x0: int, ch: int, cw: int) -> torch.Tensor:
    _, h, w, _ = img.shape
    patch = img[:, y0:y0 + ch, x0:x0 + cw].permute(0, 3, 1, 2)
    out = F.interpolate(patch, size=(h, w), mode="bilinear", align_corners=False, antialias=False)
    return out.permute(0, 2, 3, 1)


def center_crop(img: torch.Tensor, ratio: float = 0.9) -> torch.Tensor:
    ch, cw = _window(img, ratio)
    return _crop_resize(img, (img.shape[1] - ch) // 2, (img.shape[2] - cw) // 2, ch, cw)


def random_crop(img: torch.Tensor, generator: Optional[torch.Generator] = None, ratio: float = 0.9,
                offset: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Train-mode crop: the window at ``offset`` = (y0, x0) where given, else
    at an offset drawn uniformly on the CPU from ``generator`` (seed 0 when
    None), y0 first."""
    ch, cw = _window(img, ratio)
    if offset is None:
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        offset = (int(torch.randint(0, img.shape[1] - ch + 1, (), generator=g)),
                  int(torch.randint(0, img.shape[2] - cw + 1, (), generator=g)))
    return _crop_resize(img, int(offset[0]), int(offset[1]), ch, cw)
