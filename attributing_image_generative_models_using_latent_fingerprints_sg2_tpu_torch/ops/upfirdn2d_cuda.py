"""The 4-tap FIR kernels of the synthesis network (``csrc/upfirdn2d.cu``).

Counterpart of the reference's ``ops/upfirdn2d_pallas.py``:

- ``blur4``:   up=down=1 separable 4x4 FIR with pads (p0, p1) per axis, the
               post-transpose blur of every upsample styled conv;
- ``upblur4``: up=2, pad (2, 1) separable 4x4 FIR, the ToRGB skip upsample;
               ``upblur4_add(rgb, x, k)`` is the same kernel with the add it
               feeds fused in (``rgb + upblur4(x)``), and its backward is one
               launch of the adjoint kernel ``upblur4_adj`` (the reference
               computes that adjoint outside Pallas).

Each public function runs its plain PyTorch version on a CPU tensor and the
CUDA kernel on a CUDA tensor: float32, or bfloat16 through the kernels' bf16
variants (``*_bf16``), else it raises.  A bf16 tensor stays bf16 end to end;
the kernels and their plain versions sum in float32 and round each output to
bf16 once, where the reference's TPU kernels round.  On a CUDA tensor
every backward is itself an autograd Function over these three kernels, so
the ops are differentiable to any order (training's R1 penalty takes a
gradient of a gradient through the discriminator's blurs).  Taps are the
per-axis kernel *including* its gain, as in the reference.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from ._cuda import FLOAT, INT, PTR, Kernel, by_dtype, check_cuda_operands, register, widen

BLUR4 = register(Kernel(
    "blur4", "fp_blur4_f32", [PTR, PTR] + [INT] * 8 + [FLOAT] * 8,
    source="csrc/upfirdn2d.cu",
    replaces="attributing_image_generative_models_using_latent_fingerprints_sg2_tpu/ops/upfirdn2d_pallas.py:127",
))
UPBLUR4 = register(Kernel(
    "upblur4", "fp_upblur4_f32", [PTR, PTR, PTR] + [INT] * 4 + [FLOAT] * 4,
    source="csrc/upfirdn2d.cu",
    replaces="attributing_image_generative_models_using_latent_fingerprints_sg2_tpu/ops/upfirdn2d_pallas.py:216",
))
UPBLUR4_ADJ = register(Kernel(
    "upblur4_adj", "fp_upblur4_adj_f32", [PTR, PTR] + [INT] * 4 + [FLOAT] * 4,
    source="csrc/upfirdn2d.cu",
    replaces="attributing_image_generative_models_using_latent_fingerprints_sg2_tpu/ops/upfirdn2d_pallas.py:235",
))
BLUR4_BF16 = register(Kernel(
    "blur4_bf16", "fp_blur4_bf16", BLUR4.argtypes[:-1], source=BLUR4.source, replaces=BLUR4.replaces))
UPBLUR4_BF16 = register(Kernel(
    "upblur4_bf16", "fp_upblur4_bf16", UPBLUR4.argtypes[:-1], source=UPBLUR4.source, replaces=UPBLUR4.replaces))
UPBLUR4_ADJ_BF16 = register(Kernel(
    "upblur4_adj_bf16", "fp_upblur4_adj_bf16", UPBLUR4_ADJ.argtypes[:-1], source=UPBLUR4_ADJ.source,
    replaces=UPBLUR4_ADJ.replaces))


def depthwise_correlate(
    x: torch.Tensor, k2d: torch.Tensor, pads: Tuple[int, int, int, int], stride=1
) -> torch.Tensor:
    """NHWC depthwise correlation with one 2-D kernel; pads = (y0, y1, x0, x1) >= 0,
    stride an int or (y, x)."""
    c = x.shape[-1]
    t = F.pad(x.permute(0, 3, 1, 2), (pads[2], pads[3], pads[0], pads[1]))
    w = k2d.to(x.dtype).expand(c, 1, *k2d.shape).contiguous()
    return F.conv2d(t, w, stride=stride, groups=c).permute(0, 2, 3, 1)


def _outer(a: Sequence[float], b: Sequence[float], like: torch.Tensor) -> torch.Tensor:
    return torch.outer(torch.tensor(list(a), dtype=torch.float32),
                       torch.tensor(list(b), dtype=torch.float32)).to(like.device)


# ---------------------------------------------------------------------------
# plain versions: the result in the input's dtype; a bf16 input is widened to
# float32 exactly and its result rounded once, as the kernels do
# ---------------------------------------------------------------------------


def blur4_plain(x, ky, kx, pad_y, pad_x) -> torch.Tensor:
    """upfirdn2d(x, outer(ky, kx), pad=...): correlate with the flipped kernel."""
    k = _outer(tuple(ky)[::-1], tuple(kx)[::-1], x)
    return depthwise_correlate(widen(x), k, (pad_y[0], pad_y[1], pad_x[0], pad_x[1])).to(x.dtype)


def blur4_strips(x, ky, kx, pad_y, pad_x, rows: int = 64, vec: int = 4) -> torch.Tensor:
    """:func:`blur4_plain` computed as the kernel walks it, in plain PyTorch:
    strips of ``rows`` output rows, each reading rows + 3 input rows; per input
    row the 4-tap horizontal sum (taps summed left to right), then the vertical
    sum over a 4-row sliding window (top to bottom); channels in groups of
    ``vec`` with a scalar remainder; zeros outside the input.  For the tests."""
    n, h, w, c = x.shape
    fy, fx = tuple(ky)[::-1], tuple(kx)[::-1]
    oh, ow = h + pad_y[0] + pad_y[1] - 3, w + pad_x[0] + pad_x[1] - 3
    y = x.new_zeros((n, oh, ow, c))
    cmain = c - c % vec
    groups = [slice(c0, c0 + vec) for c0 in range(0, cmain, vec)] + [slice(c0, c0 + 1) for c0 in range(cmain, c)]
    for ch in groups:
        width = ch.stop - ch.start
        for oy0 in range(0, oh, rows):
            for ox in range(ow):
                win = [x.new_zeros((n, width)) for _ in range(4)]
                for r in range(min(rows, oh - oy0) + 3):
                    iy = oy0 - pad_y[0] + r
                    taps = [x[:, iy, ox - pad_x[0] + j, ch]
                            if 0 <= iy < h and 0 <= ox - pad_x[0] + j < w else x.new_zeros((n, width))
                            for j in range(4)]
                    win = win[1:] + [fx[0] * taps[0] + fx[1] * taps[1] + fx[2] * taps[2] + fx[3] * taps[3]]
                    if r >= 3:
                        y[:, oy0 + r - 3, ox, ch] = fy[0] * win[0] + fy[1] * win[1] + fy[2] * win[2] + fy[3] * win[3]
    return y


def _upblur4_wide(x, k) -> torch.Tensor:
    n, h, w, c = x.shape
    u = x.new_zeros((n, 2 * h, 2 * w, c), dtype=torch.promote_types(x.dtype, torch.float32))
    u[:, ::2, ::2] = x
    kf = tuple(k)[::-1]
    return depthwise_correlate(u, _outer(kf, kf, x), (2, 1, 2, 1))


def upblur4_plain(x, k) -> torch.Tensor:
    """upfirdn2d(x, outer(k, k), up=2, pad=(2, 1)): zero-stuff, pad, correlate."""
    return _upblur4_wide(x, k).to(x.dtype)


def upblur4_add_plain(rgb, x, k) -> torch.Tensor:
    """``rgb + upblur4(x, k)``, summed wide and rounded once, as the fused kernel."""
    return (widen(rgb) + _upblur4_wide(x, k)).to(rgb.dtype)


def upblur4_adjoint_plain(g: torch.Tensor, k) -> torch.Tensor:
    """Adjoint of upblur4: down=2 correlation with outer(k, k), pad (1, 1)
    (the reference's ``_upblur4_bwd``)."""
    return depthwise_correlate(widen(g), _outer(k, k, g), (1, 1, 1, 1), stride=2).to(g.dtype)


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


def blur4_launch(x, fy, fx, pad_y, pad_x) -> torch.Tensor:
    """Launch with FLIPPED taps fy/fx (correlation taps)."""
    kernel = by_dtype(check_cuda_operands("blur4", x), BLUR4, BLUR4_BF16)
    n, h, w, c = x.shape
    oh = h + pad_y[0] + pad_y[1] - 3
    ow = w + pad_x[0] + pad_x[1] - 3
    if oh <= 0 or ow <= 0:
        raise ValueError(f"blur4: empty output for input {tuple(x.shape)} and pads {pad_y}, {pad_x}")
    y = torch.empty((n, oh, ow, c), device=x.device, dtype=x.dtype)
    kernel(x.data_ptr(), y.data_ptr(), n, h, w, c, oh, ow, pad_y[0], pad_x[0], *fy, *fx)
    return y


class _Blur4(torch.autograd.Function):
    """blur4 with taps ky, kx: one launch forward.  Its adjoint is blur4 again,
    with the taps reversed and pads (3 - p0, 3 - p1), through this Function, so
    the adjoint's own backward is the forward: differentiable to any order
    (the R1 penalty of training differentiates through it twice)."""

    @staticmethod
    def forward(ctx, x, ky, kx, pad_y, pad_x):
        ctx.taps = (ky, kx, pad_y, pad_x)
        return blur4_launch(x.contiguous(), ky[::-1], kx[::-1], pad_y, pad_x)

    @staticmethod
    def backward(ctx, g):
        ky, kx, pad_y, pad_x = ctx.taps
        dx = _Blur4.apply(g, ky[::-1], kx[::-1], (3 - pad_y[0], 3 - pad_y[1]), (3 - pad_x[0], 3 - pad_x[1]))
        return dx, None, None, None, None


def upblur4_launch(x, k, rgb=None) -> torch.Tensor:
    """upblur4(x) (+ ``rgb`` [N, 2H, 2W, C] when given) with UNFLIPPED taps ``k``."""
    kernel = by_dtype(check_cuda_operands("upblur4", x, *([] if rgb is None else [rgb])), UPBLUR4, UPBLUR4_BF16)
    n, h, w, c = x.shape
    y = torch.empty((n, 2 * h, 2 * w, c), device=x.device, dtype=x.dtype)
    if rgb is not None and rgb.shape != y.shape:
        raise ValueError(f"upblur4: rgb {tuple(rgb.shape)} does not match the output {tuple(y.shape)}")
    kernel(x.data_ptr(), None if rgb is None else rgb.data_ptr(), y.data_ptr(), n, h, w, c, *k[::-1])
    return y


def upblur4_adjoint_launch(g, k) -> torch.Tensor:
    """The adjoint of upblur4 applied to g [N, 2H, 2W, C], UNFLIPPED taps ``k``."""
    kernel = by_dtype(check_cuda_operands("upblur4_adj", g), UPBLUR4_ADJ, UPBLUR4_ADJ_BF16)
    n, oh, ow, c = g.shape
    if oh % 2 or ow % 2:
        raise ValueError(f"upblur4_adj: odd cotangent size {tuple(g.shape)}")
    dx = torch.empty((n, oh // 2, ow // 2, c), device=g.device, dtype=g.dtype)
    kernel(g.data_ptr(), dx.data_ptr(), n, oh // 2, ow // 2, c, *k)
    return dx


class _Upblur4(torch.autograd.Function):
    """upblur4(x) + rgb (rgb may be None): one launch forward, one backward
    (through :class:`_Upblur4Adj`, so it is differentiable again)."""

    @staticmethod
    def forward(ctx, x, rgb, k):
        ctx.k = k
        return upblur4_launch(x.contiguous(), k, None if rgb is None else rgb.contiguous())

    @staticmethod
    def backward(ctx, g):
        dx = _Upblur4Adj.apply(g, ctx.k) if ctx.needs_input_grad[0] else None
        return dx, (g if ctx.needs_input_grad[1] else None), None


class _Upblur4Adj(torch.autograd.Function):
    """upblur4's adjoint: one launch of ``upblur4_adj``; its backward is
    upblur4 without the add."""

    @staticmethod
    def forward(ctx, g, k):
        ctx.k = k
        return upblur4_adjoint_launch(g.contiguous(), k)

    @staticmethod
    def backward(ctx, gg):
        return _Upblur4.apply(gg, None, ctx.k), None


def blur4(x: torch.Tensor, ky, kx, pad_y, pad_x) -> torch.Tensor:
    """4x4 separable FIR on NHWC, out = H + pad0 + pad1 - 3 per axis."""
    ky, kx = tuple(float(v) for v in ky), tuple(float(v) for v in kx)
    pad_y, pad_x = tuple(int(v) for v in pad_y), tuple(int(v) for v in pad_x)
    if x.device.type == "cpu":
        return blur4_plain(x, ky, kx, pad_y, pad_x)
    return _Blur4.apply(x, ky, kx, pad_y, pad_x)


def upblur4(x: torch.Tensor, k) -> torch.Tensor:
    """upfirdn2d(x, outer(k, k), up=2, pad=(2, 1)) on NHWC, out = 2H x 2W."""
    k = tuple(float(v) for v in k)
    if x.device.type == "cpu":
        return upblur4_plain(x, k)
    return _Upblur4.apply(x, None, k)


def upblur4_add(rgb: torch.Tensor, x: torch.Tensor, k) -> torch.Tensor:
    """``rgb + upblur4(x, k)`` in one pass: the ToRGB skip connection."""
    k = tuple(float(v) for v in k)
    if x.device.type == "cpu":
        return upblur4_add_plain(rgb, x, k)
    return _Upblur4.apply(x, rgb, k)
