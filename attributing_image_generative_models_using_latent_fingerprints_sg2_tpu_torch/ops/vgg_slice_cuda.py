"""Fused VGG16 slice 1 (``csrc/vgg_slice1.cu``): conv 3->64 + ReLU + conv 64->64 + ReLU.

Counterpart of the reference's ``ops/vgg_slice_pallas.py::vgg_slice1``.  The
intermediate ``relu1_1`` is never stored: the forward kernel keeps it in
shared memory, and the backward kernel computes dx from (g, a2, x),
recomputing conv1's sign.  The forward's 64 -> 64 conv and the backward's two
adjoint convs run on the tensor cores (three-pass TF32 split, float32
accuracy) from weights packed once per weight tensor by ``ops/tf32.py``.  A
bfloat16 ``x`` goes to the bf16 variants (``vgg_slice1_fwd_bf16``,
``vgg_slice1_bwd_bf16``, both on ``wgmma`` with their weights resident in
each block of a persistent grid): one pass of bf16 products with float32 sums, the
float32 biases added before each rounding, ``relu1_1`` and dz1 rounded to bf16
where the reference's TPU kernel rounds them.  dw and db are computed in plain
PyTorch, and only when asked for.
"""

from __future__ import annotations

import torch

from ._cuda import INT, PTR, Kernel, by_dtype, check_cuda_operands, register
from .tf32 import conv3x3_three_pass, flip_io, packed_weights
from .vgg_cuda import conv3x3_relu_plain

FWD_TILE = (8, 16)        # output tile (rows, columns) of the float32 forward kernel (csrc/vgg_slice1.cu)
FWD_TILE_BF16 = (16, 16)  # output tile of the bf16 forward kernel
BWD_TILE = 14             # dx tile of the backward kernels

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
SLICE1_FWD_BF16 = register(Kernel(
    "vgg_slice1_fwd_bf16", "fp_vgg_slice1_fwd_bf16", SLICE1_FWD.argtypes[:-1], source=SLICE1_FWD.source,
    replaces=SLICE1_FWD.replaces))
SLICE1_BWD_BF16 = register(Kernel(
    "vgg_slice1_bwd_bf16", "fp_vgg_slice1_bwd_bf16", SLICE1_BWD.argtypes[:-1], source=SLICE1_BWD.source,
    replaces=SLICE1_BWD.replaces))


def vgg_slice1_plain(x, w1, b1, w2, b2) -> torch.Tensor:
    """The kernels' plain version; a bf16 x rounds relu1_1 and the output once
    each, from float32 sums with float32 biases, as the bf16 kernels do."""
    return conv3x3_relu_plain(conv3x3_relu_plain(x, w1, b1), w2, b2)


def _check_shapes(x, w1, w2) -> None:
    if x.shape[-1] != 3 or tuple(w1.shape) != (3, 3, 3, 64) or tuple(w2.shape) != (3, 3, 64, 64):
        raise ValueError(
            f"vgg_slice1: expected x [N,H,W,3], w1 [3,3,3,64], w2 [3,3,64,64]; got "
            f"{tuple(x.shape)}, {tuple(w1.shape)}, {tuple(w2.shape)}"
        )


def slice1_forward_launch(x, w1, b1, w2, b2) -> torch.Tensor:
    """One launch of the forward kernel of x's dtype; the parameters are float32
    (or x's dtype), w1 goes in x's dtype and the biases as float32."""
    dtype = check_cuda_operands("vgg_slice1", x)
    check_cuda_operands("vgg_slice1", w1, b1, w2, b2)
    _check_shapes(x, w1, w2)
    n, h, w, _ = x.shape
    y = torch.empty((n, h, w, 64), device=x.device, dtype=x.dtype)
    args = (x, w1.to(dtype), b1.float(), packed_weights(w2, 64, dtype=dtype), b2.float(), y)
    by_dtype(dtype, SLICE1_FWD, SLICE1_FWD_BF16)(*(t.data_ptr() for t in args), n, h, w)
    return y


def slice1_backward_launch(g, a2, x, w1, b1, w2) -> torch.Tensor:
    """One launch of the backward kernel of x's dtype: dx from (g, a2, x)."""
    dtype = check_cuda_operands("vgg_slice1", g, a2, x)
    check_cuda_operands("vgg_slice1", w1, b1, w2)
    _check_shapes(x, w1, w2)
    w1fp, w2fp = packed_weights(w1, 8, True, dtype), packed_weights(w2, 64, True, dtype)
    n, h, w, _ = x.shape
    dx = torch.empty_like(x)
    args = (g, a2, x, w1.to(dtype), b1.float(), w1fp, w2fp, dx)
    by_dtype(dtype, SLICE1_BWD, SLICE1_BWD_BF16)(*(t.data_ptr() for t in args), n, h, w)
    return dx


def _band(src: torch.Tensor, y0: int, x0: int, rows: int, cols: int) -> torch.Tensor:
    """src[:, y0 : y0 + rows, x0 : x0 + cols] with zeros outside the image."""
    n, h, w, c = src.shape
    out = src.new_zeros((n, rows, cols, c))
    ys, xs = max(y0, 0), max(x0, 0)
    ye, xe = min(y0 + rows, h), min(x0 + cols, w)
    if ye > ys and xe > xs:
        out[:, ys - y0:ye - y0, xs - x0:xe - x0] = src[:, ys:ye, xs:xe]
    return out


def _valid_conv(v: torch.Tensor, w_hwio: torch.Tensor) -> torch.Tensor:
    """3x3 conv without padding: the halo is already in ``v``."""
    y = torch.nn.functional.conv2d(v.permute(0, 3, 1, 2), w_hwio.permute(3, 2, 0, 1))
    return y.permute(0, 2, 3, 1)


def vgg_slice1_forward_tiled(x, w1, b1, w2, b2, tile=FWD_TILE) -> torch.Tensor:
    """:func:`vgg_slice1_plain` computed as the forward kernel walks it, in plain
    PyTorch: per ``tile`` (rows, columns) of the output, a1 = relu(conv1(x) + b1)
    on the tile plus a 1-pixel halo from x with a 2-pixel halo, zero outside the
    image (conv2's padding), then conv2 as the three TF32 products of split
    operands (``conv3x3_three_pass``) + b2 + ReLU.  For the tests."""
    n, h, w, _ = x.shape
    th, tw = tile
    y = x.new_zeros((n, h, w, 64))
    ones = x.new_ones((n, h, w, 1))
    for ty0 in range(0, h, th):
        for tx0 in range(0, w, tw):
            a1 = torch.relu(_valid_conv(_band(x, ty0 - 2, tx0 - 2, th + 4, tw + 4), w1) + b1)
            a1 = a1 * _band(ones, ty0 - 1, tx0 - 1, th + 2, tw + 2)
            # the halo is in a1 already: keep the interior of the padded product
            a2 = torch.relu(conv3x3_three_pass(a1, w2, b2)[:, 1:-1, 1:-1])
            ye, xe = min(ty0 + th, h), min(tx0 + tw, w)
            y[:, ty0:ye, tx0:xe] = a2[:, :ye - ty0, :xe - tx0]
    return y


def vgg_slice1_backward_tiled(g, a2, x, w1, b1, w2, tile: int = BWD_TILE) -> torch.Tensor:
    """dx of :func:`vgg_slice1_plain` computed as the backward kernel walks it,
    in plain PyTorch: per ``tile`` x ``tile`` block of dx, dz2 = g * [a2 > 0] on
    the tile plus a 2-pixel halo (zero outside the image), da1 = conv_T(dz2, w2)
    on the tile plus 1 pixel, dz1 = da1 * [conv1(x) + b1 > 0] (zero outside the
    image), dx = conv_T(dz1, w1) on the tile.  For the tests."""
    n, h, w, _ = x.shape
    w1f, w2f = flip_io(w1), flip_io(w2)
    dx = torch.zeros_like(x)

    ones = x.new_ones((n, h, w, 1))
    masked_g = torch.where(a2 > 0, g, torch.zeros_like(g))
    for ty0 in range(0, h, tile):
        for tx0 in range(0, w, tile):
            dz2 = _band(masked_g, ty0 - 2, tx0 - 2, tile + 4, tile + 4)
            da1 = _valid_conv(dz2, w2f)
            z1 = _valid_conv(_band(x, ty0 - 2, tx0 - 2, tile + 4, tile + 4), w1) + b1
            inside = _band(ones, ty0 - 1, tx0 - 1, tile + 2, tile + 2) > 0
            dz1 = torch.where((z1 > 0) & inside, da1, torch.zeros_like(da1))
            d = _valid_conv(dz1, w1f)
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
