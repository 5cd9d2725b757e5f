"""The port's CUDA kernels against their plain PyTorch versions, on the GPU.

Marked ``gpu``; skipped (with a reason) where no CUDA device is present.
Run on a GPU machine with ``python -m pytest tests/test_torch_gpu.py -q -m gpu``.
Tolerance: 1e-4 * max(1, max|plain|), float32 with TF32 off (another
summation order over up to 9*C terms; the tensor-core kernels sum three TF32
products of split operands in the tensor cores' float32 accumulators).
"""

import pytest
import torch

from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.ops import (
    _cuda,
    tf32,
    upfirdn2d_cuda,
    vgg_cuda,
    vgg_slice_cuda,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.ops.upfirdn2d import (
    make_kernel,
    split_symmetric_4tap,
)

pytestmark = pytest.mark.gpu
TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU or interpret mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(*shape, scale=1.0, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g) * scale


def _close(k, p):
    assert torch.isfinite(k).all()
    assert (k - p).abs().max().item() <= TOL * max(1.0, p.abs().max().item())


def _check(kernel_fn, plain_fn, x, cot, masked_plain=None, keep=None):
    """Forward and dx against plain, dx through autograd on both sides.

    Past a ReLU the two forwards' masks [y > 0] differ wherever y is within
    rounding of zero, and each dx is then the exact gradient of its own
    forward.  ``masked_plain(v, y)``, where given, is the plain version with
    its LAST ReLU replaced by the mask [y > 0] of the kernel's output, so that
    autograd differentiates the plain arithmetic under the kernel's mask.
    ``keep`` (a mask over dx) leaves out, and the test bounds, the elements
    that an inner ReLU's sign within rounding of zero can move."""
    xk = x.clone().requires_grad_(True)
    xp = x.clone().requires_grad_(True)
    yk, yp = kernel_fn(xk), plain_fn(xp)
    (dk,) = torch.autograd.grad(yk, xk, cot)
    yref = yp if masked_plain is None else masked_plain(xp, yk.detach())
    (dp,) = torch.autograd.grad(yref, xp, cot)
    torch.cuda.synchronize()
    _close(yk, yp)
    if keep is not None:
        assert keep.float().mean().item() > 0.99
        dk, dp = dk * keep, dp * keep
    _close(dk, dp)


def _adjoint_plain(cot, wt):
    """conv3x3_plain's adjoint applied to ``cot``, by autograd (the conv is linear)."""
    x0 = torch.zeros_like(cot).requires_grad_(True)
    return torch.autograd.grad(vgg_cuda.conv3x3_plain(x0, wt), x0, cot)[0]


K1 = split_symmetric_4tap(make_kernel((1, 3, 3, 1)) * 4.0)


@pytest.mark.parametrize("c,h,pads", [(64, 17, (1, 1)), (8, 13, (2, 1)), (3, 9, (0, 3))])
def test_blur4_kernel(cuda, c, h, pads):
    x = _rand(2, h, h, c).to(cuda)
    oh = h + sum(pads) - 3
    cot = _rand(2, oh, oh, c, seed=1).to(cuda)
    _check(lambda v: upfirdn2d_cuda.blur4(v, K1, K1, pads, pads),
           lambda v: upfirdn2d_cuda.blur4_plain(v, K1, K1, pads, pads), x, cot)


@pytest.mark.parametrize("c,h", [(3, 8), (3, 5), (16, 4)])
def test_upblur4_kernel(cuda, c, h):
    x = _rand(2, h, h, c).to(cuda)
    cot = _rand(2, 2 * h, 2 * h, c, seed=1).to(cuda)
    _check(lambda v: upfirdn2d_cuda.upblur4(v, K1), lambda v: upfirdn2d_cuda.upblur4_plain(v, K1), x, cot)


CONV_SHAPES = [(64, 16, 16), (128, 12, 20), (64, 5, 9),               # small and ragged
               (128, 128, 128), (256, 64, 64), (512, 32, 32), (512, 16, 16),  # the 256px main path
               (256, 13, 33), (512, 9, 17)]


def _conv_inputs(cuda, c, h, w):
    wt = _rand(3, 3, c, c, scale=(2.0 / (9 * c)) ** 0.5, seed=2).to(cuda)
    return (wt, _rand(c, scale=0.1, seed=3).to(cuda), _rand(2, h, w, c).to(cuda),
            _rand(2, h, w, c, seed=1).to(cuda))


@pytest.mark.parametrize("c,h,w", CONV_SHAPES)
def test_conv3x3_relu_kernel(cuda, c, h, w):
    wt, b, x, cot = _conv_inputs(cuda, c, h, w)
    _check(lambda v: vgg_cuda.conv3x3_relu(v, wt, b), lambda v: vgg_cuda.conv3x3_relu_plain(v, wt, b), x, cot,
           lambda v, y: vgg_cuda.conv3x3_plain(v, wt, b) * (y > 0))


@pytest.mark.parametrize("c,h,w", CONV_SHAPES)
def test_conv3x3_launch_forward_and_dx(cuda, c, h, w):
    """The launch function alone: conv + bias + ReLU, and the adjoint conv of the dx pass."""
    wt, b, x, cot = _conv_inputs(cuda, c, h, w)
    _close(vgg_cuda.conv3x3_launch(x, wt, b, relu=True), vgg_cuda.conv3x3_relu_plain(x, wt, b))
    _close(vgg_cuda.conv3x3_launch(cot, wt, None, relu=False, flip=True), _adjoint_plain(cot, wt))


def test_packed_weights_follow_an_in_place_change(cuda):
    """The packing is reused across calls and redone when the weight changes in place."""
    wt, b, x, cot = _conv_inputs(cuda, 128, 12, 20)
    packs = tf32.pack_count
    for _ in range(3):
        _close(vgg_cuda.conv3x3_launch(x, wt, b, relu=True), vgg_cuda.conv3x3_relu_plain(x, wt, b))
    assert tf32.pack_count == packs + 1
    wt.mul_(-0.5)
    _close(vgg_cuda.conv3x3_launch(x, wt, b, relu=True), vgg_cuda.conv3x3_relu_plain(x, wt, b))
    _close(vgg_cuda.conv3x3_launch(cot, wt, None, relu=False, flip=True), _adjoint_plain(cot, wt))
    assert tf32.pack_count == packs + 3


def _slice_weights(cuda):
    return (_rand(3, 3, 3, 64, scale=(2 / 27) ** 0.5, seed=4).to(cuda), _rand(64, scale=0.1, seed=5).to(cuda),
            _rand(3, 3, 64, 64, scale=(2 / 576) ** 0.5, seed=6).to(cuda), _rand(64, scale=0.1, seed=7).to(cuda))


def _slice_keep(x, ws):
    """dx elements outside the 3x3 neighbourhoods of pixels where some channel of
    conv1(x) + b1 is within rounding (1e-5) of zero: there the kernel's recomputed
    sign (its own fmaf order) may differ from cuDNN's."""
    z1 = vgg_cuda.conv3x3_plain(x.detach(), ws[0], ws[1])
    near = (z1.abs().amin(dim=-1, keepdim=True) < 1e-5).float().permute(0, 3, 1, 2)
    return ~(torch.nn.functional.max_pool2d(near, 3, stride=1, padding=1).permute(0, 2, 3, 1) > 0)


@pytest.mark.parametrize("h,w", [(16, 16), (13, 22), (14, 14), (29, 43), (256, 256)])
def test_vgg_slice1_backward_launch(cuda, h, w):
    """The backward kernel alone, on the plain forward's a2, against autograd of plain
    and against the tiled plain walk.  Where |conv1(x) + b1| is within rounding of zero
    the kernel's recomputed sign may differ from cuDNN's: those 3x3 neighbourhoods are
    left out (a handful of pixels at most)."""
    ws = _slice_weights(cuda)
    x = _rand(2, h, w, 3).to(cuda).requires_grad_(True)
    cot = _rand(2, h, w, 64, seed=1).to(cuda)
    yp = vgg_slice_cuda.vgg_slice1_plain(x, *ws)
    (want,) = torch.autograd.grad(yp, x, cot)
    got = vgg_slice_cuda.slice1_backward_launch(cot, yp.detach(), x.detach(), ws[0], ws[1], ws[2])
    keep = _slice_keep(x, ws)
    assert keep.float().mean().item() > 0.99
    _close(got * keep, want * keep)
    if h <= 64:
        tiled = vgg_slice_cuda.vgg_slice1_backward_tiled(cot, yp.detach(), x.detach(), ws[0], ws[1], ws[2])
        _close(got * keep, tiled * keep)


@pytest.mark.parametrize("h,w,seed", [(16, 16, 0), (13, 22, 0), (256, 256, 0), (256, 256, 11), (256, 256, 12)])
def test_vgg_slice1_kernel(cuda, h, w, seed):
    """The wrapper (kernel forward, then kernel backward) against autograd of plain.
    The backward masks by [a2 > 0] of its own forward, which differs from plain's
    by rounding: the reference takes the kernel's mask for the last ReLU, and the
    neighbourhoods that conv1's sign can move are left out (under 1%)."""
    ws = _slice_weights(cuda)
    x = _rand(2, h, w, 3, seed=seed).to(cuda)
    cot = _rand(2, h, w, 64, seed=seed + 1).to(cuda)

    def masked_plain(v, y):
        a1 = torch.relu(vgg_cuda.conv3x3_plain(v, ws[0], ws[1]))
        return vgg_cuda.conv3x3_plain(a1, ws[2], ws[3]) * (y > 0)

    _check(lambda v: vgg_slice_cuda.vgg_slice1(v, *ws), lambda v: vgg_slice_cuda.vgg_slice1_plain(v, *ws), x, cot,
           masked_plain, _slice_keep(x, ws))


def test_kernels_refuse_bfloat16(cuda):
    x = torch.zeros(1, 8, 8, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        upfirdn2d_cuda.blur4(x, K1, K1, (1, 1), (1, 1))
    with pytest.raises(TypeError):
        vgg_cuda.conv3x3_relu(x, torch.zeros(3, 3, 64, 64, device=cuda), torch.zeros(64, device=cuda))


def test_launches_are_counted(cuda):
    _cuda.reset_launches()
    upfirdn2d_cuda.upblur4(torch.zeros(1, 4, 4, 3, device=cuda), K1)
    torch.cuda.synchronize()
    assert _cuda.launch_counts()["upblur4"] == 1
