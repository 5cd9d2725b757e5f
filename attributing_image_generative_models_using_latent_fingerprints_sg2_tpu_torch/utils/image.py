"""Image post-processing and PNG output (the reference's ``make_image`` /
``store_results`` layout: original/ watermarked/ watermark_pos/ watermark_neg/)."""

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
