"""Image post-processing and PNG output (the reference's ``make_image`` /
``store_results`` layout: original/ watermarked/ watermark_pos/ watermark_neg/),
and image files in: PIL decode, center crop and area resample (the reference
package's ``training/folder.py`` PIL path)."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch


def make_image(imgs: torch.Tensor) -> np.ndarray:
    """[-1, 1] float NHWC tensor -> uint8 NHWC numpy (``make_image_np``)."""
    return make_image_np(imgs.detach().float().cpu().numpy())


def make_image_np(img: np.ndarray) -> np.ndarray:
    """[-1, 1] float32 numpy image(s) -> uint8: clamp, +1, *255/2, round half
    to even.  In numpy, so the server's HTTP threads never start intra-op
    thread teams of their own."""
    return np.round((np.clip(img, -1.0, 1.0) + 1.0) * np.float32(255.0 / 2.0)).astype(np.uint8)


def encode_png(arr: np.ndarray) -> bytes:
    """uint8 HWC -> PNG bytes, encoded in memory (the serving path)."""
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def _save_png(arr: np.ndarray, path: str) -> None:
    from PIL import Image

    Image.fromarray(arr).save(path)


def store_results(
    save_dir: str,
    index: int,
    original_image_w0: Optional[np.ndarray] = None,
    original_image_wx: Optional[np.ndarray] = None,
    watermark_pos: Optional[np.ndarray] = None,
    watermark_neg: Optional[np.ndarray] = None,
) -> None:
    """Write each category's batch; element i lands in ``{index + i:06d}.png``."""
    cats = {
        "original/": original_image_w0,
        "watermarked/": original_image_wx,
        "watermark_pos/": watermark_pos,
        "watermark_neg/": watermark_neg,
    }
    for sub, batch in cats.items():
        if batch is None:
            continue
        d = os.path.join(save_dir, sub)
        os.makedirs(d, exist_ok=True)
        for i in range(batch.shape[0]):
            _save_png(np.asarray(batch[i]), os.path.join(d, f"{index + i:06d}.png"))


def watermark_images(wx_img_u8: np.ndarray, w0_img_u8: np.ndarray):
    """Positive / negative watermark visualizations: clip(wx - w0) and the reverse."""
    diff = wx_img_u8.astype(np.int16) - w0_img_u8.astype(np.int16)
    return np.clip(diff, 0, 255).astype(np.uint8), np.clip(-diff, 0, 255).astype(np.uint8)


def area_resample(img: np.ndarray, target: int) -> np.ndarray:
    """Center-crop [H, W, 3] uint8 to a square and box-resample it to
    [target, target, 3]: output pixel i averages the input span
    [i*s/t, (i+1)*s/t) with fractional edge coverage, separably, in float64,
    rounding half up.  Down- and up-sampling alike."""
    h, w = img.shape[:2]
    s = min(h, w)
    y0, x0 = (h - s) // 2, (w - s) // 2
    out = img[y0:y0 + s, x0:x0 + s].astype(np.float64)
    if s != target:
        m = _axis_matrix(s, target)
        out = np.einsum("ts,shc->thc", m, out)
        out = np.einsum("ts,hsc->htc", m, out)
    return np.clip(np.floor(out + 0.5), 0, 255).astype(np.uint8)


def _axis_matrix(s: int, t: int) -> np.ndarray:
    """[t, s] row-stochastic box-filter taps (fractional edge coverage)."""
    scale = s / t
    m = np.zeros((t, s), dtype=np.float64)
    for i in range(t):
        a, b = i * scale, (i + 1) * scale
        for j in range(int(np.floor(a)), min(int(np.ceil(b)), s)):
            m[i, j] = (min(j + 1.0, b) - max(float(j), a)) / scale
    return m


def load_image(path: str, target: int) -> np.ndarray:
    """An image file (anything PIL decodes) -> [target, target, 3] uint8."""
    from PIL import Image

    with Image.open(path) as im:
        arr = np.asarray(im.convert("RGB"), dtype=np.uint8)
    return area_resample(arr, target)


def to_training_range(batch_u8: np.ndarray) -> np.ndarray:
    """uint8 [0, 255] -> float32 [-1, 1] (the generator's output range)."""
    return batch_u8.astype(np.float32) / 127.5 - 1.0
