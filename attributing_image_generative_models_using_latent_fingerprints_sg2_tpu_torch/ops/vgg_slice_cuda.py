"""Fused VGG16 slice 1 (``csrc/vgg_slice1.cu``): conv 3->64 + ReLU + conv 64->64 + ReLU.

Counterpart of the reference's ``ops/vgg_slice_pallas.py::vgg_slice1``.  The
intermediate ``relu1_1`` is never stored: the forward kernel keeps it in
shared memory, and the backward kernel computes dx from (g, a2, x),
recomputing conv1's sign.  dw and db are computed in plain PyTorch, and only
when asked for.
"""

from __future__ import annotations

import torch

from ._cuda import INT, PTR, Kernel, check_cuda_f32, register
from .vgg_cuda import conv3x3_plain, flip_io

SLICE1_FWD = register(Kernel(
    "vgg_slice1_fwd", "fp_vgg_slice1_fwd_f32", [PTR] * 6 + [INT] * 3,
    source="csrc/vgg_slice1.cu",
    replaces="attributing_image_generative_models_using_latent_fingerprints_sg2_tpu/ops/vgg_slice_pallas.py:248",
))
SLICE1_BWD = register(Kernel(
    "vgg_slice1_bwd", "fp_vgg_slice1_bwd_f32", [PTR] * 8 + [INT] * 3,
    source="csrc/vgg_slice1.cu",
    replaces="attributing_image_generative_models_using_latent_fingerprints_sg2_tpu/ops/vgg_slice_pallas.py:349",
))


def vgg_slice1_plain(x, w1, b1, w2, b2) -> torch.Tensor:
    a1 = torch.relu(conv3x3_plain(x, w1, b1))
    return torch.relu(conv3x3_plain(a1, w2, b2))


def _check_shapes(x, w1, w2) -> None:
    if x.shape[-1] != 3 or tuple(w1.shape) != (3, 3, 3, 64) or tuple(w2.shape) != (3, 3, 64, 64):
        raise ValueError(
            f"vgg_slice1: expected x [N,H,W,3], w1 [3,3,3,64], w2 [3,3,64,64]; got "
            f"{tuple(x.shape)}, {tuple(w1.shape)}, {tuple(w2.shape)}"
        )


def slice1_forward_launch(x, w1, b1, w2, b2) -> torch.Tensor:
    check_cuda_f32("vgg_slice1", x, w1, b1, w2, b2)
    _check_shapes(x, w1, w2)
    n, h, w, _ = x.shape
    y = torch.empty((n, h, w, 64), device=x.device, dtype=x.dtype)
    SLICE1_FWD(*(t.data_ptr() for t in (x, w1, b1, w2, b2, y)), n, h, w)
    return y


def slice1_backward_launch(g, a2, x, w1, b1, w2) -> torch.Tensor:
    w1f, w2f = flip_io(w1), flip_io(w2)
    check_cuda_f32("vgg_slice1", g, a2, x, w1, b1, w1f, w2f)
    n, h, w, _ = x.shape
    dx = torch.empty_like(x)
    SLICE1_BWD(*(t.data_ptr() for t in (g, a2, x, w1, b1, w1f, w2f, dx)), n, h, w)
    return dx


class _VggSlice1(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        args = [t.contiguous() for t in (x, w1, b1, w2, b2)]
        y = slice1_forward_launch(*args)
        ctx.save_for_backward(*args, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, w1, b1, w2, b2, a2 = ctx.saved_tensors
        dx = None
        if ctx.needs_input_grad[0]:
            dx = slice1_backward_launch(g.contiguous(), a2, x, w1, b1, w2)
        dws = (None,) * 4
        if any(ctx.needs_input_grad[1:]):
            with torch.enable_grad():
                ws = [t.detach().requires_grad_(True) for t in (w1, b1, w2, b2)]
                out = vgg_slice1_plain(x, *ws)
                dws = torch.autograd.grad(out, ws, g)
        return (dx, *dws)


def vgg_slice1(x, w1, b1, w2, b2) -> torch.Tensor:
    """relu(conv(relu(conv(x, w1) + b1), w2) + b2), NHWC, 3 -> 64 -> 64."""
    if x.device.type == "cpu":
        return vgg_slice1_plain(x, w1, b1, w2, b2)
    return _VggSlice1.apply(x, w1, b1, w2, b2)
