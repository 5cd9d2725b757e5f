"""The port's CUDA kernels against their plain PyTorch versions, on the GPU.

Marked ``gpu``; skipped (with a reason) where no CUDA device is present.
Run on a GPU machine with ``python -m pytest tests/test_torch_gpu.py -q -m gpu``.
Tolerance: 1e-4 * max(1, max|plain|), float32 with TF32 off (another
summation order over up to 9*C terms; the tensor-core kernels sum three TF32
products of split operands in the tensor cores' float32 accumulators).  The
bfloat16 variants (``*_bf16`` kernels) against the plain versions in bf16:
max|kernel - plain| < 0.03 * max|plain|, the reference's own bound for its
bf16 kernels (both sides round each output to bf16, one after another
summation order, so they may differ by an ulp, 2^-8 of the value).
"""

import dataclasses

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
BF16_TOL = 0.03


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


def _close_bf16(k, p):
    assert k.dtype == p.dtype == torch.bfloat16 and torch.isfinite(k).all()
    assert (k.float() - p.float()).abs().max().item() < BF16_TOL * p.float().abs().max().item()


def _check(kernel_fn, plain_fn, x, cot, masked_plain=None, keep=None, close=_close):
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
    close(yk, yp)
    if keep is not None:
        assert keep.float().mean().item() > 0.99
        dk, dp = dk * keep, dp * keep
    close(dk, dp)


def _adjoint_plain(cot, wt):
    """conv3x3_plain's adjoint applied to ``cot``, by autograd (the conv is linear)."""
    x0 = torch.zeros_like(cot).requires_grad_(True)
    return torch.autograd.grad(vgg_cuda.conv3x3_plain(x0, wt), x0, cot)[0]


K1 = split_symmetric_4tap(make_kernel((1, 3, 3, 1)) * 4.0)


# (C, H, W, pads): small scalar-path shapes (C % 4 != 0), then 16-byte channel
# vectors at main-path widths, the adjoint's pads, odd H != W, several row strips
BLUR4_CASES = [(64, 17, 17, (1, 1)), (8, 13, 13, (2, 1)), (3, 9, 9, (0, 3)),
               (128, 33, 21, (1, 1)), (128, 32, 20, (2, 2)), (512, 9, 9, (1, 1)), (512, 8, 8, (2, 2)),
               (512, 17, 31, (2, 1)), (128, 257, 257, (1, 1)), (128, 256, 256, (2, 2)), (12, 70, 5, (0, 3))]


@pytest.mark.parametrize("c,h,w,pads", BLUR4_CASES)
def test_blur4_kernel(cuda, c, h, w, pads):
    x = _rand(2, h, w, c).to(cuda)
    oh, ow = h + sum(pads) - 3, w + sum(pads) - 3
    cot = _rand(2, oh, ow, c, seed=1).to(cuda)
    _check(lambda v: upfirdn2d_cuda.blur4(v, K1, K1, pads, pads),
           lambda v: upfirdn2d_cuda.blur4_plain(v, K1, K1, pads, pads), x, cot)


@pytest.mark.parametrize("c", [128, 8])
def test_blur4_kernel_on_a_tensor_off_the_16_byte_grid(cuda, c):
    """A contiguous view whose first element is 4 bytes past a 16-byte boundary:
    the launch must not read it in 16-byte pieces."""
    base = _rand(2 * 13 * 10 * c + 1).to(cuda)
    x = base[1:].view(2, 13, 10, c)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    _close(upfirdn2d_cuda.blur4(x, K1, K1, (1, 1), (1, 1)), upfirdn2d_cuda.blur4_plain(x, K1, K1, (1, 1), (1, 1)))
    _close(upfirdn2d_cuda.blur4(x, K1, K1, (2, 2), (2, 2)), upfirdn2d_cuda.blur4_plain(x, K1, K1, (2, 2), (2, 2)))


@pytest.mark.parametrize("c,h", [(3, 8), (3, 5), (16, 4)])
def test_upblur4_kernel(cuda, c, h):
    x = _rand(2, h, h, c).to(cuda)
    cot = _rand(2, 2 * h, 2 * h, c, seed=1).to(cuda)
    _check(lambda v: upfirdn2d_cuda.upblur4(v, K1), lambda v: upfirdn2d_cuda.upblur4_plain(v, K1), x, cot)


K_SKEW = split_symmetric_4tap(make_kernel((1, 2, 3, 4)) * 4.0)  # non-palindromic: the flip matters
# (C, H, W): the main path's C = 3, an odd C (groups of 3 + a remainder), H != W, ragged blocks
UPBLUR4_CASES = [(3, 4, 4), (3, 128, 128), (3, 5, 9), (7, 6, 3), (16, 4, 4), (1, 33, 70)]


@pytest.mark.parametrize("taps", [K1, K_SKEW])
@pytest.mark.parametrize("c,h,w", UPBLUR4_CASES)
def test_upblur4_add_kernel(cuda, c, h, w, taps):
    """The fused rgb + upblur4(skip): forward, d/dskip (the adjoint kernel) and d/drgb."""
    x = _rand(2, h, w, c).to(cuda)
    rgb = _rand(2, 2 * h, 2 * w, c, seed=2).to(cuda).requires_grad_(True)
    cot = _rand(2, 2 * h, 2 * w, c, seed=1).to(cuda)
    _check(lambda v: upfirdn2d_cuda.upblur4_add(rgb, v, taps),
           lambda v: rgb + upfirdn2d_cuda.upblur4_plain(v, taps), x, cot)
    (d_rgb,) = torch.autograd.grad(upfirdn2d_cuda.upblur4_add(rgb, x, taps), rgb, cot)
    assert torch.equal(d_rgb, cot)


@pytest.mark.parametrize("taps", [K1, K_SKEW])
@pytest.mark.parametrize("c,h,w", UPBLUR4_CASES)
def test_upblur4_adjoint_launch(cuda, c, h, w, taps):
    g = _rand(2, 2 * h, 2 * w, c, seed=3).to(cuda)
    _close(upfirdn2d_cuda.upblur4_adjoint_launch(g, taps), upfirdn2d_cuda.upblur4_adjoint_plain(g, taps))


def test_to_rgb_skip_path_reaches_no_library_conv(cuda):
    """Forward and backward of the ToRGB skip run the two kernels and no
    conv / conv_transpose of PyTorch."""
    from torch.profiler import ProfilerActivity, profile

    x = _rand(2, 16, 16, 3).to(cuda).requires_grad_(True)
    rgb = _rand(2, 32, 32, 3, seed=1).to(cuda).requires_grad_(True)
    _cuda.reset_launches()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        upfirdn2d_cuda.upblur4_add(rgb, x, K1).sum().backward()
    names = {e.key for e in prof.key_averages()}
    assert not [n for n in names if "conv" in n.lower()], sorted(names)
    counts = _cuda.launch_counts()
    assert counts["upblur4"] == 1 and counts["upblur4_adj"] == 1


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
    sign (its own fmaf order) may differ from cuDNN's.  conv1 is summed in float32
    from the values the kernel sees (a bf16 x with w1 rounded to bf16)."""
    z1 = vgg_cuda.conv3x3_plain(x.detach().float(), ws[0].to(x.dtype).float(), ws[1])
    near = (z1.abs().amin(dim=-1, keepdim=True) < 1e-5).float().permute(0, 3, 1, 2)
    return ~(torch.nn.functional.max_pool2d(near, 3, stride=1, padding=1).permute(0, 2, 3, 1) > 0)


@pytest.mark.parametrize("n,h,w", [(2, 16, 16), (2, 13, 22), (2, 29, 43), (2, 256, 256), (16, 256, 256)])
def test_vgg_slice1_forward_launch(cuda, n, h, w):
    """The forward kernel alone against plain (every element: a ReLU output needs no
    mask) and, at the small sizes, against the tiled three-pass walk."""
    ws = _slice_weights(cuda)
    x = _rand(n, h, w, 3).to(cuda)
    got = vgg_slice_cuda.slice1_forward_launch(x, *ws)
    torch.cuda.synchronize()
    _close(got, vgg_slice_cuda.vgg_slice1_plain(x, *ws))
    if h <= 64:
        _close(got, vgg_slice_cuda.vgg_slice1_forward_tiled(x, *ws))


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
    """bfloat16 reaches the bf16 variants; float16 (and a launch that mixes dtypes) is refused."""
    w, b = torch.zeros(3, 3, 64, 64, device=cuda), torch.zeros(64, device=cuda)
    x = torch.zeros(1, 8, 8, 64, device=cuda, dtype=torch.bfloat16)
    _cuda.reset_launches()
    assert upfirdn2d_cuda.blur4(x, K1, K1, (1, 1), (1, 1)).dtype == torch.bfloat16
    assert vgg_cuda.conv3x3_relu(x, w, b).dtype == torch.bfloat16
    torch.cuda.synchronize()
    counts = _cuda.launch_counts()
    assert counts["blur4_bf16"] == 1 and counts["conv3x3_relu_bf16"] == 1
    assert counts["blur4"] == 0 and counts["conv3x3_relu"] == 0
    with pytest.raises(TypeError):
        upfirdn2d_cuda.blur4(x.half(), K1, K1, (1, 1), (1, 1))
    with pytest.raises(TypeError):
        vgg_cuda.conv3x3_relu(x.half(), w, b)
    with pytest.raises(TypeError):
        upfirdn2d_cuda.upblur4_add(torch.zeros(1, 8, 8, 3, device=cuda),
                                   torch.zeros(1, 4, 4, 3, device=cuda, dtype=torch.bfloat16), K1)


# ---- the bfloat16 variants, at the float32 cases' shapes ----


def _bf(t):
    return t.to(torch.bfloat16)


# bf16 only (the float32 kernel is another design): the discriminator's 256px blurs,
# pads (1, 1) on 256^2 and (2, 2) on its adjoint's 255^2; the main path's C256 and C512
# widths; channel counts whose 16-byte vectors fill a block's 256 threads unevenly (3 and
# 5 vectors a pixel, one channel chunk; 64 vectors, two chunks of 32, copied pixel by pixel)
BLUR4_BF16_CASES = BLUR4_CASES + [(128, 256, 256, (1, 1)), (128, 255, 255, (2, 2)), (256, 129, 129, (1, 1)),
                                  (512, 65, 65, (1, 1)), (512, 64, 64, (2, 2)), (24, 19, 23, (2, 1)),
                                  (40, 12, 70, (1, 2))]


@pytest.mark.parametrize("c,h,w,pads", BLUR4_BF16_CASES)
def test_blur4_bf16_kernel(cuda, c, h, w, pads):
    x = _bf(_rand(2, h, w, c).to(cuda))
    oh, ow = h + sum(pads) - 3, w + sum(pads) - 3
    cot = _bf(_rand(2, oh, ow, c, seed=1).to(cuda))
    _cuda.reset_launches()
    _check(lambda v: upfirdn2d_cuda.blur4(v, K1, K1, pads, pads),
           lambda v: upfirdn2d_cuda.blur4_plain(v, K1, K1, pads, pads), x, cot, close=_close_bf16)
    assert _cuda.launch_counts()["blur4_bf16"] == 2 and _cuda.launch_counts()["blur4"] == 0


@pytest.mark.parametrize("taps", [K1, K_SKEW])
@pytest.mark.parametrize("c,h,w", UPBLUR4_CASES)
def test_upblur4_add_bf16_kernel(cuda, c, h, w, taps):
    """The fused rgb + upblur4(skip) in bf16: forward, d/dskip (the adjoint kernel) and d/drgb,
    each a one-level launch of the skip chain's kernels."""
    x = _bf(_rand(2, h, w, c).to(cuda))
    rgb = _bf(_rand(2, 2 * h, 2 * w, c, seed=2).to(cuda)).requires_grad_(True)
    cot = _bf(_rand(2, 2 * h, 2 * w, c, seed=1).to(cuda))
    _cuda.reset_launches()
    _check(lambda v: upfirdn2d_cuda.upblur4_add(rgb, v, taps),
           lambda v: upfirdn2d_cuda.upblur4_add_plain(rgb, v, taps), x, cot, close=_close_bf16)
    counts = _cuda.launch_counts()
    assert counts["upblur4_bf16"] == 1 and counts["upblur4_adj_bf16"] == 1
    (d_rgb,) = torch.autograd.grad(upfirdn2d_cuda.upblur4_add(rgb, x, taps), rgb, cot)
    assert torch.equal(d_rgb, cot)
    g = _bf(_rand(2, 2 * h, 2 * w, c, seed=3).to(cuda))
    _close_bf16(upfirdn2d_cuda.upblur4_adjoint_launch(g, taps), upfirdn2d_cuda.upblur4_adjoint_plain(g, taps))


# ---- the bf16 ToRGB skip chain: one launch each way ----

# (N, H0, W0, C, levels): the 256px main path at batch 2; non-square and non-power-of-two
# levels; C in {1, 3, 4, 8}, so that rows start off the 16-byte grid; one-pixel level 0
CHAIN_CASES = [(2, 4, 4, 3, 6), (2, 3, 5, 1, 4), (1, 5, 3, 4, 3), (2, 7, 6, 8, 2), (3, 1, 1, 3, 5), (1, 6, 10, 3, 1)]


def _chain_levels(cuda, n, h0, w0, c, levels, offset=0):
    """t_0 .. t_L in bf16; ``offset`` > 0 puts each that many elements past an allocation's
    start, off the 16-byte grid."""
    out = []
    for k in range(levels + 1):
        t = _bf(_rand(n * (h0 << k) * (w0 << k) * c + offset, seed=10 + k).to(cuda))
        out.append(t[offset:].view(n, h0 << k, w0 << k, c))
    return out


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n,h0,w0,c,levels", CHAIN_CASES)
def test_upblur4_chain_bf16_launch(cuda, n, h0, w0, c, levels, offset):
    """The L-level forward in one launch is bit-equal to L chained one-level launches
    (rgb + upblur4 a level), and within BF16_TOL of the plain chain; so with no add at
    the top (the cascade's backward), whose last level is upblur4 alone."""
    ts = _chain_levels(cuda, n, h0, w0, c, levels, offset)
    _cuda.reset_launches()
    got = upfirdn2d_cuda.upblur4_chain_launch(ts, K_SKEW)
    torch.cuda.synchronize()
    assert _cuda.launch_counts()["upblur4_bf16"] == 1
    rgb = ts[0]
    for t in ts[1:]:
        rgb = upfirdn2d_cuda.upblur4_launch(rgb, K_SKEW, t)
    assert torch.equal(got, rgb)
    _close_bf16(got, upfirdn2d_cuda.upblur4_chain_plain(ts, K_SKEW))
    got = upfirdn2d_cuda.upblur4_chain_launch(ts[:-1] + [None], K_SKEW)
    rgb = ts[0]
    for t in ts[1:-1]:
        rgb = upfirdn2d_cuda.upblur4_launch(rgb, K_SKEW, t)
    assert torch.equal(got, upfirdn2d_cuda.upblur4_launch(rgb, K_SKEW))
    _close_bf16(got, upfirdn2d_cuda.upblur4_chain_plain(ts[:-1] + [None], K_SKEW))


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n,h0,w0,c,levels", CHAIN_CASES)
def test_upblur4_adj_chain_bf16_launch(cuda, n, h0, w0, c, levels, offset):
    """The cotangent cascade in one launch (a thread-block cluster an image): every
    level bit-equal to chained one-level adjoint launches and within BF16_TOL of the
    plain adjoint chain, the levels views of one allocation."""
    g = _chain_levels(cuda, n, h0, w0, c, levels, offset)[-1]
    _cuda.reset_launches()
    gs = upfirdn2d_cuda.upblur4_adj_chain_launch(g, K_SKEW, levels)
    torch.cuda.synchronize()
    assert _cuda.launch_counts()["upblur4_adj_bf16"] == 1 and len(gs) == levels
    assert len({t.untyped_storage().data_ptr() for t in gs}) == 1
    want = upfirdn2d_cuda.upblur4_adj_chain_plain(g, K_SKEW, levels)
    d = g
    for lev in range(levels - 1, -1, -1):
        d = upfirdn2d_cuda.upblur4_adjoint_launch(d, K_SKEW)
        assert torch.equal(gs[lev], d), lev
        _close_bf16(gs[lev], want[lev])


@pytest.mark.parametrize("levels,launches", [(7, 2), (8, 3)])
def test_upblur4_adj_chain_bf16_splits_its_widest_levels(cuda, levels, launches):
    """At 512 and 1024 px (C = 3) the cascade's widest strip does not fit its
    shared memory: the leading one or two levels go as one-level launches first,
    and every level is still bit-equal to the chained adjoint launches."""
    assert upfirdn2d_cuda.adj_chain_split(4, 4, 3, levels) == launches - 1
    g = _bf(_rand(1, 4 << levels, 4 << levels, 3, seed=5).to(cuda))
    _cuda.reset_launches()
    gs = upfirdn2d_cuda.upblur4_adj_chain_launch(g, K1, levels)
    torch.cuda.synchronize()
    assert _cuda.launch_counts()["upblur4_adj_bf16"] == launches
    d = g
    for lev in range(levels - 1, -1, -1):
        d = upfirdn2d_cuda.upblur4_adjoint_launch(d, K1)
        assert torch.equal(gs[lev], d), lev


def test_skip_chain_runs_one_launch_each_way_in_bf16(cuda):
    """upsample2x_chain on the card: in bf16 forward + backward launch
    upblur4_bf16 once and upblur4_adj_bf16 once, and reach no library conv;
    the gradients are the cascade's levels and, for the top, the cotangent
    itself.  In float32 the chain is six launches each way, as before."""
    from torch.profiler import ProfilerActivity, profile

    from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.ops.upfirdn2d import (
        upsample2x_chain,
    )

    for dtype, want in ((torch.bfloat16, {"upblur4_bf16": 1, "upblur4_adj_bf16": 1}),
                        (torch.float32, {"upblur4": 6, "upblur4_adj": 6})):
        ts = [t.to(dtype).requires_grad_(True) for t in _chain_levels(cuda, 2, 4, 4, 3, 6)]
        cot = _rand(2, 256, 256, 3, seed=2).to(cuda, dtype)
        _cuda.reset_launches()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            grads = torch.autograd.grad(upsample2x_chain(ts), ts, cot)
        torch.cuda.synchronize()
        assert {k: v for k, v in _cuda.launch_counts().items() if v} == want
        assert not [e.key for e in prof.key_averages() if "conv" in e.key.lower()]
        assert torch.equal(grads[-1], cot)
        want_grads = upfirdn2d_cuda.upblur4_adj_chain_plain(cot, K1, 6)
        for got, ref in zip(grads, want_grads):
            (_close_bf16 if dtype == torch.bfloat16 else _close)(got, ref)


def test_skip_chain_bf16_second_derivative_matches_the_cpu(cuda):
    """A gradient of a gradient through the bf16 chain on the card (chain, cascade,
    the cascade's backward = the chain with no add at the top, the cascade again)
    against the plain chain differentiated twice on the CPU, within BF16_TOL."""
    ts = [t.cpu() for t in _chain_levels(cuda, 2, 4, 4, 3, 3)]
    c = _bf(_rand(2, 32, 32, 3, seed=7))

    def second(levels, cc):
        levels = [t.clone().requires_grad_(True) for t in levels]
        out = upfirdn2d_cuda.upblur4_chain(levels, K_SKEW)
        grads = torch.autograd.grad((torch.tanh(out.float()) * cc.float()).sum(), levels, create_graph=True)
        return torch.autograd.grad(sum(gr.float().square().sum() for gr in grads), levels)

    want = second(ts, c)
    _cuda.reset_launches()
    got = second([t.to(cuda) for t in ts], c.to(cuda))
    torch.cuda.synchronize()
    counts = {k: v for k, v in _cuda.launch_counts().items() if v}
    assert counts == {"upblur4_bf16": 2, "upblur4_adj_bf16": 2}, counts
    for a, b in zip(got, want):
        _close_bf16(a.cpu(), b)


@pytest.mark.parametrize("c,h,w", CONV_SHAPES)
def test_conv3x3_relu_bf16_kernel(cuda, c, h, w):
    """Forward (float32 parameters, bf16 activations) and dx through autograd
    against the plain bf16 conv, the plain side under the kernel's ReLU mask;
    and the launch function's adjoint pass alone."""
    wt, b, x, cot = _conv_inputs(cuda, c, h, w)
    x, cot = _bf(x), _bf(cot)
    _cuda.reset_launches()
    _check(lambda v: vgg_cuda.conv3x3_relu(v, wt, b), lambda v: vgg_cuda.conv3x3_relu_plain(v, wt, b), x, cot,
           lambda v, y: vgg_cuda.conv3x3_plain(v, wt, b) * (y > 0), close=_close_bf16)
    assert _cuda.launch_counts()["conv3x3_relu_bf16"] == 2 and _cuda.launch_counts()["conv3x3_relu"] == 0
    _close_bf16(vgg_cuda.conv3x3_launch(cot, wt, None, relu=False, flip=True), _adjoint_plain(cot, wt))


# the persistent forward's 16 x 16 tiles: ragged H and W, fewer tiles than blocks (one
# SM a block: 1 x 24 x 40 is 6 tiles), more (16 x 256^2: 4096; 40 x 50 x 70: 800, ragged)
@pytest.mark.parametrize("n,h,w", [(2, 16, 16), (2, 13, 22), (2, 29, 43), (2, 256, 256), (16, 256, 256),
                                   (1, 24, 40), (40, 50, 70)])
def test_vgg_slice1_bf16_forward_launch(cuda, n, h, w):
    ws = _slice_weights(cuda)
    x = _bf(_rand(n, h, w, 3).to(cuda))
    got = vgg_slice_cuda.slice1_forward_launch(x, *ws)
    torch.cuda.synchronize()
    _close_bf16(got, vgg_slice_cuda.vgg_slice1_plain(x, *ws))


@pytest.mark.parametrize("h,w", [(16, 16), (13, 22), (14, 14), (29, 43), (256, 256)])
def test_vgg_slice1_bf16_backward_launch(cuda, h, w):
    """The bf16 backward kernel alone, on the plain bf16 forward's a2, against
    autograd of the plain bf16 slice; conv1's sign neighbourhoods left out as
    in float32."""
    ws = _slice_weights(cuda)
    x = _bf(_rand(2, h, w, 3).to(cuda)).requires_grad_(True)
    cot = _bf(_rand(2, h, w, 64, seed=1).to(cuda))
    yp = vgg_slice_cuda.vgg_slice1_plain(x, *ws)
    (want,) = torch.autograd.grad(yp, x, cot)
    got = vgg_slice_cuda.slice1_backward_launch(cot, yp.detach(), x.detach(), ws[0], ws[1], ws[2])
    keep = _slice_keep(x, ws)
    assert keep.float().mean().item() > 0.99
    _close_bf16(got * keep, want * keep)


@pytest.mark.parametrize("h,w,seed", [(16, 16, 0), (13, 22, 0), (256, 256, 0), (24, 40, 1)])
def test_vgg_slice1_bf16_kernel(cuda, h, w, seed):
    ws = _slice_weights(cuda)
    x = _bf(_rand(2, h, w, 3, seed=seed).to(cuda))
    cot = _bf(_rand(2, h, w, 64, seed=seed + 1).to(cuda))

    def masked_plain(v, y):
        a1 = vgg_cuda.conv3x3_relu_plain(v, ws[0], ws[1])
        return vgg_cuda.conv3x3_plain(a1, ws[2], ws[3]) * (y > 0)

    _cuda.reset_launches()
    _check(lambda v: vgg_slice_cuda.vgg_slice1(v, *ws), lambda v: vgg_slice_cuda.vgg_slice1_plain(v, *ws), x, cot,
           masked_plain, _slice_keep(x, ws), close=_close_bf16)
    counts = _cuda.launch_counts()
    assert counts["vgg_slice1_fwd_bf16"] == 1 and counts["vgg_slice1_bwd_bf16"] == 1


# (C, N, H, W) for the bf16 `wgmma` conv: ragged H and W (not multiples of the 8- or
# 16-row tile, nor of its 16 columns).  The first two give the launch its 16 x 16 x 128
# tiles (N * ceil(H / 16) * ceil(W / 16) * C / 128 at least the SM count, 132 on an H100),
# the next two its 8 x 16 x 128 ones, the last two 8 x 16 x 64 ones (C = 64, C % 128 ==
# 64).  The persistent blocks (one an SM, two for the 64-channel tiles) take two tiles
# where there are more tiles than blocks (144, 144 and 256 tiles on 132 blocks, 320 on
# 264), one or none where there are fewer (32 on 132, 216 on 264).
CONV_BF16_GRID_CASES = [(512, 9, 29, 29), (128, 36, 20, 30), (512, 32, 16, 16), (512, 2, 9, 17),
                        (64, 40, 29, 21), (192, 8, 23, 37)]


@pytest.mark.parametrize("c,n,h,w", CONV_BF16_GRID_CASES)
def test_conv3x3_relu_bf16_launch_at_both_tilings(cuda, c, n, h, w):
    """The launch alone, forward (bias + ReLU) and the adjoint pass, against the
    plain bf16 conv and against the float32 plain conv on the same bf16 inputs."""
    wt, b = _conv_inputs(cuda, c, 1, 1)[:2]
    x = _bf(_rand(n, h, w, c, seed=8).to(cuda))
    cot = _bf(_rand(n, h, w, c, seed=9).to(cuda))
    _cuda.reset_launches()
    y = vgg_cuda.conv3x3_launch(x, wt, b, relu=True)
    dx = vgg_cuda.conv3x3_launch(cot, wt, None, relu=False, flip=True)
    torch.cuda.synchronize()
    assert _cuda.launch_counts()["conv3x3_relu_bf16"] == 2
    _close_bf16(y, vgg_cuda.conv3x3_relu_plain(x, wt, b))
    _close_bf16(dx, _adjoint_plain(cot, wt))
    y32 = vgg_cuda.conv3x3_relu_plain(x.float(), wt.to(torch.bfloat16).float(), b)
    assert (y.float() - y32).abs().max().item() < BF16_TOL * y32.abs().max().item()


@pytest.mark.parametrize("c,n,h,w", [(64, 2, 13, 22), (512, 9, 29, 29)])
def test_conv3x3_relu_bf16_autograd_on_the_card_matches_the_cpu(cuda, c, n, h, w):
    """``conv3x3_relu`` forward and backward (dx, dw, db) in bf16 on the card
    against the same function on the CPU, where it runs its plain version.  The
    two ReLU masks may differ where an output is within rounding of zero: the
    3x3 neighbourhoods of those pixels are left out of dx (and counted)."""
    wt, b = (t.cpu() for t in _conv_inputs(cuda, c, 1, 1)[:2])
    x, cot = _bf(_rand(n, h, w, c, seed=10)), _bf(_rand(n, h, w, c, seed=11))
    outs = {}
    for dev in ("cpu", "cuda"):
        xv, wv, bv = (t.to(dev).requires_grad_(True) for t in (x, wt, b))
        y = vgg_cuda.conv3x3_relu(xv, wv, bv)
        outs[dev] = (y.detach(), *torch.autograd.grad(y, (xv, wv, bv), cot.to(dev)))
    (yc, dxc, dwc, dbc), (yg, dxg, dwg, dbg) = outs["cpu"], (t.cpu() for t in outs["cuda"])
    _close_bf16(yg, yc)
    flips = ((yg > 0) != (yc > 0)).any(dim=-1, keepdim=True).float().permute(0, 3, 1, 2)
    keep = ~(torch.nn.functional.max_pool2d(flips, 3, stride=1, padding=1).permute(0, 2, 3, 1) > 0)
    assert keep.float().mean().item() > 0.99
    _close_bf16(dxg * keep, dxc * keep)
    for got, want in ((dwg, dwc), (dbg, dbc)):
        assert got.dtype == want.dtype == torch.float32
        assert (got - want).abs().max().item() < BF16_TOL * want.abs().max().item()


@pytest.mark.parametrize("n,h,w", [(24, 29, 43), (11, 14, 14)])
def test_vgg_slice1_bf16_backward_walks_many_tiles_a_block(cuda, n, h, w):
    """The persistent backward at batches whose tile count (288, 11) is above and
    below the number of blocks (one an SM): every block takes several tiles, or
    some blocks none.  Against autograd of the plain bf16 slice, conv1's sign
    neighbourhoods left out."""
    ws = _slice_weights(cuda)
    x = _bf(_rand(n, h, w, 3, seed=12).to(cuda)).requires_grad_(True)
    cot = _bf(_rand(n, h, w, 64, seed=13).to(cuda))
    yp = vgg_slice_cuda.vgg_slice1_plain(x, *ws)
    (want,) = torch.autograd.grad(yp, x, cot)
    _cuda.reset_launches()
    got = vgg_slice_cuda.slice1_backward_launch(cot, yp.detach(), x.detach(), ws[0], ws[1], ws[2])
    torch.cuda.synchronize()
    assert _cuda.launch_counts()["vgg_slice1_bwd_bf16"] == 1
    keep = _slice_keep(x, ws)
    assert keep.float().mean().item() > 0.99
    _close_bf16(got * keep, want * keep)


def test_launches_are_counted(cuda):
    _cuda.reset_launches()
    upfirdn2d_cuda.upblur4(torch.zeros(1, 4, 4, 3, device=cuda), K1)
    torch.cuda.synchronize()
    assert _cuda.launch_counts()["upblur4"] == 1


def test_biggan_solve_step_matches_the_cpu(cuda):
    """One perceptual solve step of a tiny BigGAN (16px, attention before its last
    layer) on the card against the same step on the CPU (the kernels' plain
    versions), from one state: the loss of every restart to 1e-4 relative, the
    gradients to 1e-3 of their scale (cuDNN and the kernels sum in other orders,
    and a ReLU within rounding of zero may switch).  The LPIPS kernels run; the
    StyleGAN2 FIR kernels do not."""
    from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.config import (
        AttributionConfig,
        FingerprintConfig,
        ModelConfig,
    )
    from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.fingerprint import (
        attribute,
        pipeline,
    )
    from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.losses import lpips
    from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.models import biggan
    from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.utils.tree import tree_to

    bcfg = biggan.BigGANConfig(z_dim=16, class_embed_dim=16, channel_width=8, num_classes=10, output_dim=16,
                               attention_layer_position=2, layers=((False, 16, 16), (True, 16, 8), (True, 8, 4)),
                               n_stats=5)
    mcfg = ModelConfig(model="biggan", img_size=16, biggan_label="3")
    cpu = pipeline.build_pipeline(mcfg, FingerprintConfig(key_len=4, shift=12, n_pca_samples=500), device="cpu",
                                  generator=torch.Generator().manual_seed(0), biggan_cfg=bcfg)
    cpu.gen_params["attn"]["gamma"] = torch.tensor(0.7)
    targets = pipeline.generate_fingerprinted(cpu, 2, torch.Generator().manual_seed(1))[0]
    acfg = AttributionConfig(steps=1, n_starts=3, loss="perceptual")
    alpha0 = torch.randn((2, 3, 12), generator=torch.Generator().manual_seed(2)) * cpu.basis.sigma_rest
    out = {}
    _cuda.reset_launches()
    for dev in ("cpu", "cuda"):
        basis = dataclasses.replace(cpu.basis, **{f.name: getattr(cpu.basis, f.name).to(dev)
                                                  for f in dataclasses.fields(cpu.basis) if f.name != "sd_moved"})
        feats = [f[:, None] for f in lpips.extract_features(tree_to(cpu.lpips_params, dev), targets.to(dev))]
        _, per_elem = attribute.make_attribution_step(
            tree_to(cpu.gen_params, dev), tree_to(cpu.lpips_params, dev), basis, [], mcfg, acfg, feats, None,
            biggan_cfg=bcfg, class_onehot=cpu.class_onehot.to(dev), truncation=cpu.truncation)
        alpha = alpha0.to(dev).requires_grad_(True)
        key = torch.zeros((2, 3, 4), device=dev).requires_grad_(True)
        per = per_elem(alpha, key)
        out[dev] = [t.detach().cpu() for t in (per, *torch.autograd.grad(per.sum(), [alpha, key]))]
    torch.cuda.synchronize()
    counts = _cuda.launch_counts()
    assert counts["conv3x3_relu"] > 0 and counts["vgg_slice1_fwd"] > 0 and counts["vgg_slice1_bwd"] > 0
    assert counts["blur4"] == counts["upblur4"] == counts["upblur4_adj"] == 0
    (pc, gac, gkc), (pg, gag, gkg) = out["cpu"], out["cuda"]
    assert torch.isfinite(pg).all() and (pg - pc).abs().max().item() <= 1e-4 * pc.abs().max().item()
    for gc, gg in ((gac, gag), (gkc, gkg)):
        assert (gg - gc).abs().max().item() <= 1e-3 * gc.abs().max().item()


K0 = split_symmetric_4tap(make_kernel((1, 3, 3, 1)))  # the discriminator's blur: no gain
# (C, input size, pads): the discriminator's blurs, (2, 2) before a 3x3 stride-2
# conv (output r + 1) and (1, 1) before the 1x1 skip (output r - 1), at the
# widths of the full-width model's blocks and at C % 4 != 0
DISC_BLUR_CASES = [(128, 64, (2, 2)), (128, 64, (1, 1)), (256, 32, (2, 2)), (512, 8, (2, 2)), (512, 8, (1, 1)),
                   (6, 16, (2, 2)), (6, 16, (1, 1))]


@pytest.mark.parametrize("c,r,pads", DISC_BLUR_CASES)
def test_blur4_kernel_at_the_discriminators_pads(cuda, c, r, pads):
    x = _rand(2, r, r, c).to(cuda)
    o = r + sum(pads) - 3
    cot = _rand(2, o, o, c, seed=1).to(cuda)
    _check(lambda v: upfirdn2d_cuda.blur4(v, K0, K0, pads, pads),
           lambda v: upfirdn2d_cuda.blur4_plain(v, K0, K0, pads, pads), x, cot)


def _second_derivative(fn, x, c):
    """d/dx sum(g^2) with g = d/dx sum(tanh(fn(x)) * c): a gradient of a
    gradient through ``fn``, as the R1 penalty takes one through the blurs."""
    x = x.clone().requires_grad_(True)
    (g,) = torch.autograd.grad((torch.tanh(fn(x)) * c).sum(), x, create_graph=True)
    return torch.autograd.grad(g.square().sum(), x)[0]


@pytest.mark.parametrize("op", ["blur4_p22", "blur4_p11", "blur4_skew", "upblur4", "upblur4_add"])
def test_second_derivative_on_the_card_matches_the_cpu(cuda, op):
    """The kernels' autograd Functions differentiated twice on the card against
    the plain versions differentiated twice on the CPU; every launch of the
    card's graph (forward, adjoint, the adjoint's backward) is a kernel."""
    skew = split_symmetric_4tap(make_kernel((1, 2, 3, 4)) * 4.0)
    if op.startswith("blur4"):
        pads = {"blur4_p22": (2, 2), "blur4_p11": (1, 1), "blur4_skew": (1, 2)}[op]
        taps = skew if op == "blur4_skew" else K0
        x = _rand(2, 17, 17, 128)
        fn = lambda v: upfirdn2d_cuda.blur4(v, taps, taps[::-1], pads, pads[::-1])  # noqa: E731
        out = 17 + sum(pads) - 3
        c = _rand(2, out, out, 128, seed=1)
    else:
        x = _rand(2, 9, 9, 3)
        rgb = _rand(2, 18, 18, 3, seed=2)
        fn = ((lambda v: upfirdn2d_cuda.upblur4(v, skew)) if op == "upblur4"
              else (lambda v: upfirdn2d_cuda.upblur4_add(rgb.to(v.device), v, skew)))
        c = _rand(2, 18, 18, 3, seed=1)
    want = _second_derivative(fn, x, c)
    _cuda.reset_launches()
    got = _second_derivative(fn, x.to(cuda), c.to(cuda))
    torch.cuda.synchronize()
    counts = _cuda.launch_counts()
    # forward, its adjoint, the adjoint's backward (the forward again), the forward's adjoint again
    want_launches = {"blur4": 4} if op.startswith("blur4") else {"upblur4": 2, "upblur4_adj": 2}
    assert {k: v for k, v in counts.items() if v} == want_launches
    _close(got.cpu(), want)


def test_train_step_matches_the_cpu(cuda):
    """Two training steps of the 16px configuration (step 0 with R1) on the card
    against the same steps on the CPU from one state and one draw: losses to
    1e-4 relative, both networks' gradients (Adam's first moment, b1 = 0) to
    1e-3 of their scale (cuDNN and the kernels sum in other orders through
    three discriminator passes and R1's second derivative)."""
    from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.config import ModelConfig
    from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.training import gan
    from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.utils.tree import (
        tree_leaves,
        tree_map,
    )

    mcfg = ModelConfig(img_size=16, style_dim=32, n_mlp=2, channel_max=32)
    tcfg = gan.TrainConfig(batch=4, d_reg_every=2)
    cpu = gan.init_train_state(mcfg, tcfg, torch.Generator().manual_seed(0), "cpu")
    card = dataclasses.replace(cpu, **{f: tree_map(lambda t: t.to(cuda), getattr(cpu, f))
                                       for f in ("g_params", "d_params", "g_ema")},
                               g_opt=gan.init_adam(tree_map(lambda t: t.to(cuda), cpu.g_params)),
                               d_opt=gan.init_adam(tree_map(lambda t: t.to(cuda), cpu.d_params)))
    mkldnn = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False  # PyTorch's direct CPU convs: the closer float32 reference
    try:
        for step in range(2):
            draws = gan.draw_step(3, step, mcfg, tcfg, "cpu")
            _cuda.reset_launches()
            card, mk = gan.train_step(card, {"real": draws["real"].to(cuda), "d": draws["d"].to(cuda),
                                             "g": draws["g"].to(cuda)}, mcfg, tcfg)
            torch.cuda.synchronize()
            counts = _cuda.launch_counts()
            cpu, mc = gan.train_step(cpu, draws, mcfg, tcfg)
            assert counts["blur4"] > 0 and counts["upblur4"] > 0 and counts["upblur4_adj"] > 0
            for k in ("d_loss", "r1", "g_loss"):
                assert abs(mk[k].item() - mc[k].item()) <= 1e-4 * max(abs(mc[k].item()), 1e-6), k
            assert (mc["r1"].item() > 0) == (step == 0)
            for opt in ("g_opt", "d_opt"):
                for a, b in zip(tree_leaves(getattr(card, opt)["mu"]), tree_leaves(getattr(cpu, opt)["mu"])):
                    assert (a.cpu() - b).abs().max().item() <= 1e-3 * max(b.abs().max().item(), 1e-12)
    finally:
        torch.backends.mkldnn.enabled = mkldnn


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_remat_synthesis_on_the_card(cuda, dtype, monkeypatch):
    """A 64px synthesis gradient-checkpointed on the card, cuDNN held to its
    deterministic algorithms (with the default ones two float32 runs of one
    input differ in rounding): the image bitwise the plain one (the same
    forward kernels, each bitwise deterministic), the latent's gradient within
    1e-5 of its scale of the plain one in float32 and within BF16_TOL in bf16;
    each block's forward blur4 launched once more in the backward, the skip
    chain's launches as without."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.config import ModelConfig
    from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.models import stylegan2 as sg2

    cfg = ModelConfig(img_size=64, style_dim=64, n_mlp=2, channel_max=64)
    params = sg2.init_generator_params(cfg, torch.Generator().manual_seed(0), cuda)
    lat = _rand(2, cfg.n_latent, 64, seed=1).to(cuda, dtype)
    cot = _rand(2, 64, 64, 3, seed=2).to(cuda, dtype)
    out = {}
    for remat in (False, True):
        w = lat.clone().requires_grad_(True)
        _cuda.reset_launches()
        img = sg2.synthesis(params, w, params["noises"], remat=remat)
        (g,) = torch.autograd.grad(img, w, cot)
        torch.cuda.synchronize()
        out[remat] = (img.detach(), g, {k: v for k, v in _cuda.launch_counts().items() if v})
    (img0, g0, n0), (img1, g1, n1) = out[False], out[True]
    assert torch.equal(img0, img1)
    if dtype == torch.float32:
        assert (g1 - g0).abs().max().item() <= 1e-5 * g0.abs().max().item()
    else:
        _close_bf16(g1, g0)
    sfx = "_bf16" if dtype == torch.bfloat16 else ""
    blocks = len(params["to_rgbs"])
    assert n1 == {**n0, "blur4" + sfx: n0["blur4" + sfx] + blocks} and n0["blur4" + sfx] == 2 * blocks
