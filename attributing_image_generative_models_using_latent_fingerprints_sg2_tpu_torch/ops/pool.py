"""2x2 stride-2 max pool on NHWC with the reference's gradient convention.

Counterpart of the reference's ``ops/pool.py``: the backward splits the
cotangent EVENLY over tied maxima of a window (``jnp.max``'s convention),
where ``F.max_pool2d`` routes it to one element.
"""

from __future__ import annotations

import torch


def _pool(x: torch.Tensor) -> torch.Tensor:
    b, h, w, c = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"maxpool2x2 requires even H and W; got H={h}, W={w}")
    return x.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


class _MaxPool2x2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = _pool(x)
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        b, h2, w2, c = y.shape
        xr = x.reshape(b, h2, 2, w2, 2, c)
        mask = (xr == y[:, :, None, :, None, :]).to(g.dtype)
        cnt = mask.sum(dim=(2, 4))  # tie counts, >= 1
        dx = mask * (g / cnt)[:, :, None, :, None, :]
        return dx.reshape(x.shape)


def maxpool2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2/2 max pool, NHWC, H and W even."""
    return _MaxPool2x2.apply(x)
