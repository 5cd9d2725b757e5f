"""Upsample-FIR-downsample 2D resampling (``upfirdn2d``) on NHWC tensors.

Counterpart of the reference's ``ops/upfirdn2d.py``.  Semantics (rosinality
``upfirdn2d_native``): zero-stuff by ``up`` (each sample followed by up-1
zeros), pad or crop by signed ``(pad0, pad1)`` per axis, convolve with the
FIR kernel (correlate with its flip), keep every ``down``-th sample.

Two cases dispatch to the FIR kernels of ``upfirdn2d_cuda`` (CUDA kernels
on a CUDA tensor, their plain versions on a CPU one): a 4x4 separable
symmetric kernel with up=down=1 and pads in [0, 3] (``blur4``: the
synthesis network's post-transpose blur, and the discriminator's blur before
each stride-2 conv), and the same kernel with up=2, pad (2, 1) (``upblur4``;
``upsample2x_add`` is its fusion with the ToRGB skip's add, and
``upsample2x_chain`` the whole skip chain of a synthesis).
Everything else takes the general path below.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import upfirdn2d_cuda

Pad = Union[Tuple[int, int], Tuple[int, int, int, int]]


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        a, b = v
        return int(a), int(b)
    return int(v), int(v)


def _pad4(pad: Pad) -> Tuple[int, int, int, int]:
    """Normalize to (pad_x0, pad_x1, pad_y0, pad_y1)."""
    if len(pad) == 2:
        p0, p1 = pad
        return int(p0), int(p1), int(p0), int(p1)
    return tuple(int(v) for v in pad)  # type: ignore[return-value]


def make_kernel(k: Sequence[float]) -> np.ndarray:
    """Normalized FIR kernel; a 1-D input becomes its outer product."""
    k = np.asarray(k, dtype=np.float32)
    if k.ndim == 1:
        k = np.outer(k, k)
    return k / k.sum()


def split_symmetric_4tap(kernel_np: np.ndarray) -> Optional[Tuple[float, ...]]:
    """If ``kernel`` is outer(k, k) with len(k) == 4, return k (gain split
    evenly over the two axes, positive mass), else None."""
    if kernel_np.shape != (4, 4):
        return None
    u, s, vt = np.linalg.svd(kernel_np.astype(np.float64))
    if s[1] > 1e-6 * max(s[0], 1e-30):
        return None
    ky = u[:, 0] * np.sqrt(s[0])
    kx = vt[0, :] * np.sqrt(s[0])
    if not np.allclose(ky, kx, atol=1e-6):
        if np.allclose(ky, -kx, atol=1e-6):
            ky, kx = -ky, -kx
        else:
            return None
    if ky.sum() < 0:
        ky = -ky
    return tuple(float(v) for v in ky)


def upfirdn2d_general(x: torch.Tensor, kernel_np: np.ndarray, up, down, pads) -> torch.Tensor:
    """The plain general path: any kernel, up, down and signed pads."""
    (up_y, up_x), (pad_x0, pad_x1, pad_y0, pad_y1) = up, pads
    if up != (1, 1):
        n, h, w, c = x.shape
        u = x.new_zeros(n, h * up_y, w * up_x, c)
        u[:, ::up_y, ::up_x] = x
        x = u
    x = x[:, max(-pad_y0, 0): x.shape[1] - max(-pad_y1, 0),
          max(-pad_x0, 0): x.shape[2] - max(-pad_x1, 0)]
    k = torch.from_numpy(np.ascontiguousarray(kernel_np[::-1, ::-1])).to(x.device)
    return upfirdn2d_cuda.depthwise_correlate(
        x, k, (max(pad_y0, 0), max(pad_y1, 0), max(pad_x0, 0), max(pad_x1, 0)), stride=down)


def upfirdn2d(
    x: torch.Tensor,
    kernel,
    up: Union[int, Tuple[int, int]] = 1,
    down: Union[int, Tuple[int, int]] = 1,
    pad: Pad = (0, 0),
) -> torch.Tensor:
    """upfirdn2d on NHWC input.

    ``pad`` is (pad0, pad1) for both axes or (x0, x1, y0, y1); pads may be
    negative (crop).  Output: [N, (H*up_y + pad_y0 + pad_y1 - kh)//down_y + 1, ..., C].
    """
    up = _pair(up)
    down = _pair(down)
    pads = _pad4(pad)
    kernel_np = np.asarray(kernel, dtype=np.float32)
    if kernel_np.ndim == 1:
        kernel_np = np.outer(kernel_np, kernel_np)

    if down == (1, 1) and kernel_np.shape == (4, 4):
        k1d = split_symmetric_4tap(kernel_np)
        if k1d is not None:
            pad_x0, pad_x1, pad_y0, pad_y1 = pads
            # pads in [0, 3]: the adjoint is blur4 again, at pads 3 - p
            if up == (1, 1) and min(pads) >= 0 and max(pads) <= 3:
                return upfirdn2d_cuda.blur4(x, k1d, k1d, (pad_y0, pad_y1), (pad_x0, pad_x1))
            if up == (2, 2) and pads == (2, 1, 2, 1):
                return upfirdn2d_cuda.upblur4(x, k1d)
    return upfirdn2d_general(x, kernel_np, up, down, pads)


def upsample2x(x: torch.Tensor, kernel=(1, 3, 3, 1)) -> torch.Tensor:
    """2x upsample (ref Upsample module): gain 4, pad0=(p+1)//2+1, pad1=p//2."""
    k = make_kernel(kernel) * 4.0
    p = k.shape[0] - 2
    return upfirdn2d(x, k, up=2, down=1, pad=((p + 1) // 2 + 1, p // 2))


def downsample2x(x: torch.Tensor, kernel=(1, 3, 3, 1)) -> torch.Tensor:
    """2x downsample (ref Downsample module): pad0=(p+1)//2, pad1=p//2, down=2."""
    k = make_kernel(kernel)
    p = k.shape[0] - 2
    return upfirdn2d(x, k, down=2, pad=((p + 1) // 2, p // 2))


def upsample2x_add(rgb: torch.Tensor, skip: torch.Tensor, kernel=(1, 3, 3, 1)) -> torch.Tensor:
    """``rgb + upsample2x(skip, kernel)``; one fused pass for a 4-tap kernel."""
    k1d = split_symmetric_4tap(make_kernel(kernel) * 4.0) if len(kernel) == 4 else None
    if k1d is None:
        return rgb + upsample2x(skip, kernel)
    return upfirdn2d_cuda.upblur4_add(rgb, skip, k1d)


def upsample2x_chain(ts: Sequence[torch.Tensor], kernel=(1, 3, 3, 1)) -> torch.Tensor:
    """The ToRGB skip chain of a synthesis, ``ts`` = [t_0, ..., t_L] the ToRGB
    outputs from the smallest up: rgb_0 = t_0, rgb_k = t_k + upsample2x(rgb_{k-1});
    returns rgb_L.  A 4-tap kernel goes to ``upfirdn2d_cuda.upblur4_chain``
    (one launch each way in bf16 on the card), else level by level."""
    k1d = split_symmetric_4tap(make_kernel(kernel) * 4.0) if len(kernel) == 4 else None
    if k1d is not None:
        return upfirdn2d_cuda.upblur4_chain(ts, k1d)
    rgb = ts[0]
    for t in ts[1:]:
        rgb = t + upsample2x(rgb, kernel)
    return rgb


def blur(x: torch.Tensor, kernel, pad: Tuple[int, int], upsample_factor: int = 1) -> torch.Tensor:
    """Plain FIR blur (ref Blur module)."""
    k = make_kernel(kernel)
    if upsample_factor > 1:
        k = k * (upsample_factor ** 2)
    return upfirdn2d(x, k, pad=pad)
