"""Fused VGG16 slice 1 (``csrc/vgg_slice1.cu``): conv 3->64 + ReLU + conv 64->64 + ReLU.

Counterpart of the reference's ``ops/vgg_slice_pallas.py::vgg_slice1``.  The
intermediate ``relu1_1`` is never stored: the forward kernel keeps it in
shared memory, and the backward kernel computes dx from (g, a2, x),
recomputing conv1's sign.  The backward runs its two adjoint convs on the
tensor cores (three-pass TF32 split, float32 accuracy) from weights packed
once per weight tensor by ``ops/tf32.py``.  dw and db are computed in plain
PyTorch, and only when asked for.
"""

from __future__ import annotations

import torch

from ._cuda import INT, PTR, Kernel, check_cuda_f32, register
from .tf32 import flip_io, packed_weights
from .vgg_cuda import conv3x3_plain

BWD_TILE = 14  # dx tile of the backward kernel (csrc/vgg_slice1.cu)

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
    check_cuda_f32("vgg_slice1", g, a2, x, w1, b1, w2)
    _check_shapes(x, w1, w2)
    w1fp, w2fp = packed_weights(w1, 8, flip=True), packed_weights(w2, 64, flip=True)
    n, h, w, _ = x.shape
    dx = torch.empty_like(x)
    SLICE1_BWD(*(t.data_ptr() for t in (g, a2, x, w1, b1, w1fp, w2fp, dx)), n, h, w)
    return dx


def vgg_slice1_backward_tiled(g, a2, x, w1, b1, w2, tile: int = BWD_TILE) -> torch.Tensor:
    """dx of :func:`vgg_slice1_plain` computed as the backward kernel walks it,
    in plain PyTorch: per ``tile`` x ``tile`` block of dx, dz2 = g * [a2 > 0] on
    the tile plus a 2-pixel halo (zero outside the image), da1 = conv_T(dz2, w2)
    on the tile plus 1 pixel, dz1 = da1 * [conv1(x) + b1 > 0] (zero outside the
    image), dx = conv_T(dz1, w1) on the tile.  For the tests."""
    n, h, w, _ = x.shape
    w1f, w2f = flip_io(w1), flip_io(w2)
    dx = torch.zeros_like(x)

    def band(src, y0, x0, size):
        """src[:, y0 : y0 + size, x0 : x0 + size] with zeros outside the image."""
        out = src.new_zeros((n, size, size, src.shape[-1]))
        ys, xs_ = max(y0, 0), max(x0, 0)
        ye, xe = min(y0 + size, h), min(x0 + size, w)
        if ye > ys and xe > xs_:
            out[:, ys - y0:ye - y0, xs_ - x0:xe - x0] = src[:, ys:ye, xs_:xe]
        return out

    def valid_conv(v, wf):
        """3x3 conv without padding: the halo is already in ``v``."""
        y = torch.nn.functional.conv2d(v.permute(0, 3, 1, 2), wf.permute(3, 2, 0, 1))
        return y.permute(0, 2, 3, 1)

    ones = x.new_ones((n, h, w, 1))
    for ty0 in range(0, h, tile):
        for tx0 in range(0, w, tile):
            dz2 = band(torch.where(a2 > 0, g, torch.zeros_like(g)), ty0 - 2, tx0 - 2, tile + 4)
            da1 = valid_conv(dz2, w2f)
            z1 = valid_conv(band(x, ty0 - 2, tx0 - 2, tile + 4), w1) + b1
            inside = band(ones, ty0 - 1, tx0 - 1, tile + 2) > 0
            dz1 = torch.where((z1 > 0) & inside, da1, torch.zeros_like(da1))
            d = valid_conv(dz1, w1f)
            ye, xe = min(ty0 + tile, h), min(tx0 + tile, w)
            dx[:, ty0:ye, tx0:xe] = d[:, :ye - ty0, :xe - tx0]
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
