"""Differentiable JPEG round trip (the reference package's
``attacks/diffjpeg.py``, after the DiffJPEG stack):

  RGB*255 -> YCbCr (+[0,128,128]) -> 2x chroma average pool -> 8x8 blocks
  -> DCT (input -128, scale alpha/4) -> quantize by table * factor with
     round(x) + (x - round(x))^3 (differentiable) or round(x) (hard)
  -> dequantize -> iDCT -> merge blocks -> 2x chroma nearest upsample
  -> RGB, clamp [0, 255], /255.

The whole chain runs in float32 on [0, 255].  NHWC in [-1, 1] at the attack
boundary; H and W must be multiples of 16.
"""

from __future__ import annotations

import functools
import itertools
from typing import Dict

import numpy as np
import torch

# Standard JPEG luminance / chrominance tables (Annex K), stored transposed.
_Y_TABLE = np.array(
    [
        [16, 11, 10, 16, 24, 40, 51, 61],
        [12, 12, 14, 19, 26, 58, 60, 55],
        [14, 13, 16, 24, 40, 57, 69, 56],
        [14, 17, 22, 29, 51, 87, 80, 62],
        [18, 22, 37, 56, 68, 109, 103, 77],
        [24, 35, 55, 64, 81, 104, 113, 92],
        [49, 64, 78, 87, 103, 121, 120, 101],
        [72, 92, 95, 98, 112, 100, 103, 99],
    ],
    dtype=np.float32,
).T
_C_TABLE = np.full((8, 8), 99, dtype=np.float32)
_C_TABLE[:4, :4] = np.array(
    [[17, 18, 24, 47], [18, 21, 26, 66], [24, 26, 56, 99], [47, 66, 99, 99]], dtype=np.float32
).T


def _cos_tensor(inverse: bool) -> np.ndarray:
    """[x, y, u, v] -> cos((2x+1) u pi/16) cos((2y+1) v pi/16), or with (x, y) and
    (u, v) trading places for the inverse; flattened to a 64 x 64 matrix."""
    t = np.zeros((8, 8, 8, 8), np.float32)
    for x, y, u, v in itertools.product(range(8), repeat=4):
        a, b, p, q = (u, v, x, y) if inverse else (x, y, u, v)
        t[x, y, u, v] = np.cos((2 * a + 1) * p * np.pi / 16) * np.cos((2 * b + 1) * q * np.pi / 16)
    return t.reshape(64, 64)


_ALPHA = np.outer([1.0 / np.sqrt(2)] + [1] * 7, [1.0 / np.sqrt(2)] + [1] * 7).astype(np.float32)
_NUMPY_CONSTS = {
    "alpha": _ALPHA.reshape(64), "dct": _cos_tensor(False), "idct": _cos_tensor(True),
    "y_table": _Y_TABLE.reshape(64), "c_table": _C_TABLE.reshape(64),
    "rgb2ycc": np.array([[0.299, 0.587, 0.114], [-0.168736, -0.331264, 0.5],
                         [0.5, -0.418688, -0.081312]], np.float32).T,
    "ycc2rgb": np.array([[1.0, 0.0, 1.402], [1.0, -0.344136, -0.714136], [1.0, 1.772, 0.0]],
                        np.float32).T,
    "shift": np.array([0.0, 128.0, 128.0], np.float32),
}


@functools.lru_cache(maxsize=None)
def _consts(device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(device) for k, v in _NUMPY_CONSTS.items()}


def quality_to_factor(quality: float) -> float:
    q = 5000.0 / quality if quality < 50 else 200.0 - quality * 2
    return q / 100.0


def diff_round(x: torch.Tensor) -> torch.Tensor:
    """round(x) + (x - round(x))^3: rounding with a usable gradient."""
    r = torch.round(x)
    return r + (x - r) ** 3


def _blocks(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W] -> [B, H//8 * W//8, 64]."""
    b, h, w = x.shape
    return x.reshape(b, h // 8, 8, w // 8, 8).permute(0, 1, 3, 2, 4).reshape(b, -1, 64)


def _merge(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    b = x.shape[0]
    return x.reshape(b, h // 8, w // 8, 8, 8).permute(0, 1, 3, 2, 4).reshape(b, h, w)


def jpeg_compress_decompress(img01: torch.Tensor, quality: int = 80,
                             differentiable: bool = True) -> torch.Tensor:
    """The JPEG round trip on a [0, 1] NHWC batch."""
    _, h, w, _ = img01.shape
    if h % 16 or w % 16:
        raise ValueError(f"jpeg: H and W must be multiples of 16, got {h} x {w}")
    k = _consts(img01.device)
    factor = quality_to_factor(quality)
    rounding = diff_round if differentiable else torch.round

    def channel(v, table):
        hh, ww = v.shape[1], v.shape[2]
        coef = (k["alpha"] * 0.25) * ((_blocks(v) - 128.0) @ k["dct"])
        q = rounding(coef / (table * factor)) * (table * factor)
        return _merge(0.25 * ((q * k["alpha"]) @ k["idct"]) + 128.0, hh, ww)

    def pool(v):
        return v.reshape(v.shape[0], h // 2, 2, w // 2, 2).mean(dim=(2, 4))

    def upsample(v):  # nearest, as a broadcast: its backward is a plain sum, the same in every run
        return v[:, :, None, :, None].expand(-1, -1, 2, -1, 2).reshape(v.shape[0], h, w)

    ycc = (img01 * 255.0) @ k["rgb2ycc"] + k["shift"]
    y = channel(ycc[..., 0], k["y_table"])
    cb = upsample(channel(pool(ycc[..., 1]), k["c_table"]))
    cr = upsample(channel(pool(ycc[..., 2]), k["c_table"]))
    rgb = (torch.stack([y, cb, cr], dim=-1) - k["shift"]) @ k["ycc2rgb"]
    return torch.clamp(rgb, 0.0, 255.0) / 255.0


def jpeg_attack(img: torch.Tensor, quality: int = 50, differentiable: bool = False) -> torch.Tensor:
    """[-1, 1] NHWC -> [-1, 1]; hard rounding unless ``differentiable``."""
    y01 = jpeg_compress_decompress((img + 1.0) / 2.0, quality=quality, differentiable=differentiable)
    return y01 * 2.0 - 1.0
