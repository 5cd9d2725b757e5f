"""The port's CUDA kernels against their plain PyTorch versions, on the GPU.

Marked ``gpu``; skipped (with a reason) where no CUDA device is present.
Run on a GPU machine with ``python -m pytest tests/test_torch_gpu.py -q -m gpu``.
Tolerance: 1e-4 * max(1, max|plain|), float32 with TF32 off (another
summation order over up to 9*C terms).
"""

import pytest
import torch

from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.ops import (
    _cuda,
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


def _check(kernel_fn, plain_fn, x, cot):
    xk = x.clone().requires_grad_(True)
    xp = x.clone().requires_grad_(True)
    yk, yp = kernel_fn(xk), plain_fn(xp)
    (yk * cot).sum().backward()
    (yp * cot).sum().backward()
    torch.cuda.synchronize()
    for k, p in ((yk, yp), (xk.grad, xp.grad)):
        assert (k - p).abs().max().item() <= TOL * max(1.0, p.abs().max().item())


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


@pytest.mark.parametrize("c,h,w", [(64, 16, 16), (128, 12, 20), (64, 5, 9)])
def test_conv3x3_relu_kernel(cuda, c, h, w):
    wt = _rand(3, 3, c, c, scale=(2.0 / (9 * c)) ** 0.5, seed=2).to(cuda)
    b = _rand(c, scale=0.1, seed=3).to(cuda)
    x = _rand(2, h, w, c).to(cuda)
    cot = _rand(2, h, w, c, seed=1).to(cuda)
    _check(lambda v: vgg_cuda.conv3x3_relu(v, wt, b), lambda v: vgg_cuda.conv3x3_relu_plain(v, wt, b), x, cot)


@pytest.mark.parametrize("h,w", [(16, 16), (13, 22)])
def test_vgg_slice1_kernel(cuda, h, w):
    ws = (_rand(3, 3, 3, 64, scale=(2 / 27) ** 0.5, seed=4).to(cuda), _rand(64, scale=0.1, seed=5).to(cuda),
          _rand(3, 3, 64, 64, scale=(2 / 576) ** 0.5, seed=6).to(cuda), _rand(64, scale=0.1, seed=7).to(cuda))
    x = _rand(2, h, w, 3).to(cuda)
    cot = _rand(2, h, w, 64, seed=1).to(cuda)
    _check(lambda v: vgg_slice_cuda.vgg_slice1(v, *ws), lambda v: vgg_slice_cuda.vgg_slice1_plain(v, *ws), x, cot)


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
