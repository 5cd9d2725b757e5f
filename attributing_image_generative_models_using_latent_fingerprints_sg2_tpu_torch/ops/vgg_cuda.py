"""Square 3x3 conv + bias + ReLU for the LPIPS VGG16 backbone (``csrc/conv3x3.cu``).

Counterpart of the reference's ``ops/vgg_pallas.py::conv3x3_relu``:
``relu(conv2d(x, w, stride 1, pad 1) + b)`` on NHWC with HWIO weights and
C_in == C_out.  The kernel is an implicit GEMM on the tensor cores with the
three-pass TF32 split (float32 accuracy); a bfloat16 ``x`` goes to its bf16
variant (``conv3x3_relu_bf16``: one pass of bf16 ``wgmma`` products, float32
sums, the float32 bias added before the one rounding).  Both read the weights
packed by ``ops/tf32.py`` (float32 parameters, rounded to bf16 and swizzled in
64-channel tiles for the bf16 variant),
which happens once per weight tensor and dtype, not per call.  The
backward's dx runs through the same kernel (no bias, no ReLU) on the
ReLU-masked cotangent with the packed adjoint (spatially flipped,
in/out-swapped) taps; dw and db are computed in plain PyTorch, and only when
asked for.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ._cuda import INT, PTR, Kernel, by_dtype, check_cuda_operands, register, widen
from .tf32 import packed_weights

N_TILE = 64  # output channels per block of csrc/conv3x3.cu's float32 kernel

CONV3X3 = register(Kernel(
    "conv3x3_relu", "fp_conv3x3_f32", [PTR, PTR, PTR, PTR] + [INT] * 5,
    source="csrc/conv3x3.cu",
    replaces="attributing_image_generative_models_using_latent_fingerprints_sg2_tpu/ops/vgg_pallas.py:173",
))
CONV3X3_BF16 = register(Kernel(
    "conv3x3_relu_bf16", "fp_conv3x3_bf16", CONV3X3.argtypes[:-1], source=CONV3X3.source,
    replaces=CONV3X3.replaces))


def conv3x3_plain(x: torch.Tensor, w_hwio: torch.Tensor, bias=None) -> torch.Tensor:
    """The kernels' plain conv: conv2d(x, w, stride 1, pad 1) + b on NHWC /
    HWIO, summed in at least float32 from x's values and the weights rounded
    to x's dtype, the bias added unrounded, then rounded once to x's dtype
    (in float32, the plain conv itself)."""
    xw = widen(x)
    b = None if bias is None else bias.to(xw.dtype)
    y = F.conv2d(xw.permute(0, 3, 1, 2), w_hwio.to(x.dtype).to(xw.dtype).permute(3, 2, 0, 1), b, padding=1)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def conv3x3_relu_plain(x: torch.Tensor, w_hwio: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The kernel's plain version: relu(conv3x3(x, w) + b) rounded once to x's dtype."""
    return torch.relu(conv3x3_plain(x, w_hwio, bias))


def conv3x3_launch(x: torch.Tensor, w_hwio: torch.Tensor, bias, relu: bool,
                   flip: bool = False) -> torch.Tensor:
    """One launch of the kernel of x's dtype: conv3x3(x, w) (+ bias) (ReLU), or
    with ``flip`` the adjoint conv3x3(x, tf32.flip_io(w)) that the backward's dx
    needs.  The parameters are float32 (or x's dtype); the bias goes to either
    kernel as float32."""
    dtype = check_cuda_operands("conv3x3_relu", x)
    check_cuda_operands("conv3x3_relu", w_hwio, *([bias] if bias is not None else []))
    n, h, w, c = x.shape
    if tuple(w_hwio.shape) != (3, 3, c, c):
        raise ValueError(f"conv3x3_relu: weight {tuple(w_hwio.shape)} does not fit C={c}")
    if c % 64:
        raise ValueError(f"conv3x3_relu: the CUDA kernel takes C % 64 == 0, got C={c}")
    if dtype == torch.bfloat16:  # the bf16 kernel's N tile: 128 channels, or 64 where C % 128 == 64
        wp = packed_weights(w_hwio, 128 if c % 128 == 0 else 64, flip, dtype)
    else:
        wp = packed_weights(w_hwio, N_TILE, flip, dtype)
    b = None if bias is None else bias.float()
    y = torch.empty_like(x)
    by_dtype(dtype, CONV3X3, CONV3X3_BF16)(x.data_ptr(), wp.data_ptr(), None if b is None else b.data_ptr(),
                                           y.data_ptr(), n, h, w, c, int(relu))
    return y


class _Conv3x3Relu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w_hwio, bias):
        x, w_hwio, bias = x.contiguous(), w_hwio.contiguous(), bias.contiguous()
        y = conv3x3_launch(x, w_hwio, bias, relu=True)
        ctx.save_for_backward(x, w_hwio, y)
        ctx.w_hwio = w_hwio  # the tensor object itself: the packing is cached on its identity
        return y

    @staticmethod
    def backward(ctx, g):
        x, w_hwio, y = ctx.saved_tensors
        dz = torch.where(y > 0, g, torch.zeros_like(g)).contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = conv3x3_launch(dz, ctx.w_hwio, None, relu=False, flip=True)
        if ctx.needs_input_grad[1]:
            dw_oihw = torch.nn.grad.conv2d_weight(
                x.permute(0, 3, 1, 2), (w_hwio.shape[3], w_hwio.shape[2], 3, 3),
                dz.permute(0, 3, 1, 2), padding=1,
            )
            dw = dw_oihw.permute(2, 3, 1, 0).to(w_hwio.dtype)
        if ctx.needs_input_grad[2]:
            db = dz.sum(dim=(0, 1, 2)).to(w_hwio.dtype)
        return dx, dw, db


def conv3x3_relu(x: torch.Tensor, w_hwio: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """relu(conv3x3(x, w) + b), NHWC, C_in == C_out."""
    if x.device.type == "cpu":
        return conv3x3_relu_plain(x, w_hwio, bias)
    return _Conv3x3Relu.apply(x, w_hwio, bias)
