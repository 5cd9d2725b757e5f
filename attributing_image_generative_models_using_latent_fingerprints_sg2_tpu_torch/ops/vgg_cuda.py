"""Square 3x3 conv + bias + ReLU for the LPIPS VGG16 backbone (``csrc/conv3x3.cu``).

Counterpart of the reference's ``ops/vgg_pallas.py::conv3x3_relu``:
``relu(conv2d(x, w, stride 1, pad 1) + b)`` on NHWC with HWIO weights and
C_in == C_out.  The backward's dx runs through the same kernel (no bias, no
ReLU) on the ReLU-masked cotangent with spatially flipped, in/out-swapped
taps; dw and db are computed in plain PyTorch, and only when asked for.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ._cuda import INT, PTR, Kernel, check_cuda_f32, register

CONV3X3 = register(Kernel(
    "conv3x3_relu", "fp_conv3x3_f32", [PTR, PTR, PTR, PTR] + [INT] * 5,
    source="csrc/conv3x3.cu",
    replaces="attributing_image_generative_models_using_latent_fingerprints_sg2_tpu/ops/vgg_pallas.py:173",
))


def conv3x3_plain(x: torch.Tensor, w_hwio: torch.Tensor, bias=None) -> torch.Tensor:
    """conv2d(x, w, stride 1, pad 1) + b on NHWC / HWIO."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w_hwio.permute(3, 2, 0, 1), bias, padding=1)
    return y.permute(0, 2, 3, 1)


def conv3x3_relu_plain(x: torch.Tensor, w_hwio: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    return torch.relu(conv3x3_plain(x, w_hwio, bias))


def flip_io(w_hwio: torch.Tensor) -> torch.Tensor:
    """Adjoint conv weights: spatial flip + swap in/out channels."""
    return torch.flip(w_hwio, (0, 1)).permute(0, 1, 3, 2).contiguous()


def conv3x3_launch(x: torch.Tensor, w_hwio: torch.Tensor, bias, relu: bool) -> torch.Tensor:
    check_cuda_f32("conv3x3_relu", x, w_hwio, *([bias] if bias is not None else []))
    n, h, w, c = x.shape
    if tuple(w_hwio.shape) != (3, 3, c, c):
        raise ValueError(f"conv3x3_relu: weight {tuple(w_hwio.shape)} does not fit C={c}")
    if c % 64:
        raise ValueError(f"conv3x3_relu: the CUDA kernel takes C % 64 == 0, got C={c}")
    y = torch.empty_like(x)
    CONV3X3(x.data_ptr(), w_hwio.data_ptr(), None if bias is None else bias.data_ptr(),
            y.data_ptr(), n, h, w, c, int(relu))
    return y


class _Conv3x3Relu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w_hwio, bias):
        x, w_hwio, bias = x.contiguous(), w_hwio.contiguous(), bias.contiguous()
        y = conv3x3_launch(x, w_hwio, bias, relu=True)
        ctx.save_for_backward(x, w_hwio, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, w_hwio, y = ctx.saved_tensors
        dz = torch.where(y > 0, g, torch.zeros_like(g)).contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = conv3x3_launch(dz, flip_io(w_hwio), None, relu=False)
        if ctx.needs_input_grad[1]:
            dw_oihw = torch.nn.grad.conv2d_weight(
                x.permute(0, 3, 1, 2), (w_hwio.shape[3], w_hwio.shape[2], 3, 3),
                dz.permute(0, 3, 1, 2), padding=1,
            )
            dw = dw_oihw.permute(2, 3, 1, 0)
        if ctx.needs_input_grad[2]:
            db = dz.sum(dim=(0, 1, 2))
        return dx, dw, db


def conv3x3_relu(x: torch.Tensor, w_hwio: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """relu(conv3x3(x, w) + b), NHWC, C_in == C_out."""
    if x.device.type == "cpu":
        return conv3x3_relu_plain(x, w_hwio, bias)
    return _Conv3x3Relu.apply(x, w_hwio, bias)
