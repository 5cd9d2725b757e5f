"""CPU tests of what surrounds the port's two tiled kernels: ``blur4`` walked
in row strips as ``csrc/upfirdn2d.cu`` walks it, the ``vgg_slice1`` forward
walked in tiles with conv2 as three TF32 products as ``csrc/vgg_slice1.cu``
computes it, the byte and operation counts of the ``blur4`` adjoint shapes,
and the rule that library entry points run on the card unless asked for the
CPU.

The same numpy inputs go through the JAX function and the port's.  The JAX
Pallas kernels run in TPU interpret mode, as the JAX package's own tests run
them on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.ops import upfirdn2d_pallas as jpk
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.ops import (
    vgg_slice_pallas as jslice,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.config import (
    FingerprintConfig,
    ModelConfig,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.fingerprint import pipeline
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.ops import (
    roofline,
    upfirdn2d_cuda,
    vgg_slice_cuda,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.ops.upfirdn2d import (
    make_kernel,
    split_symmetric_4tap,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.training import data

K1 = split_symmetric_4tap(make_kernel((1, 3, 3, 1)) * 4.0)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# (a) blur4 in row strips, horizontal sum first, 4-channel groups
# ---------------------------------------------------------------------------

# 1e-6 x scale: 16 products of O(1) float32 values summed in another order
# (4 + 4 taps against one 4x4 correlation) differ by a few ulp of the result.
BLUR_TOL = 1e-6


@pytest.mark.parametrize("c", [3, 8, 12])
@pytest.mark.parametrize("pads", [(1, 1), (2, 2), (2, 1), (0, 3)])
def test_blur4_strips_match_plain_and_pallas(c, pads):
    h, w = 11, 14  # odd and even, H != W
    x = _rand((2, h, w, c), 40 + c)
    tx = torch.from_numpy(x)
    want = upfirdn2d_cuda.blur4_plain(tx, K1, K1, pads, pads)
    tol = BLUR_TOL * max(1.0, want.abs().max().item())
    for rows in (64, 4):  # one strip; several strips with a ragged last one
        got = upfirdn2d_cuda.blur4_strips(tx, K1, K1, pads, pads, rows=rows)
        assert got.shape == want.shape
        assert (got - want).abs().max().item() <= tol
    with pltpu.force_tpu_interpret_mode():
        jy = np.asarray(jpk.blur4(jnp.asarray(x), K1, K1, pads, pads))
    np.testing.assert_allclose(got.numpy(), jy, atol=tol)


@pytest.mark.parametrize("c", [3, 8, 12])
@pytest.mark.parametrize("pads", [(1, 1), (2, 1)])
def test_blur4_strips_adjoint_is_the_unflipped_walk(c, pads):
    """The backward launch: the same walk with unflipped taps and pads (3 - p0,
    3 - p1), against autograd of the plain version and the JAX gradient."""
    h, w = 9, 12
    x = _rand((2, h, w, c), 50 + c)
    oh, ow = h + sum(pads) - 3, w + sum(pads) - 3
    cot = _rand((2, oh, ow, c), 51 + c)
    tx = torch.from_numpy(x).requires_grad_(True)
    (want,) = torch.autograd.grad(upfirdn2d_cuda.blur4_plain(tx, K1, K1, pads, pads), tx, torch.from_numpy(cot))
    adj = (3 - pads[0], 3 - pads[1])
    # blur4_strips flips the taps it is given, as blur4_plain does: hand it the flipped ones
    got = upfirdn2d_cuda.blur4_strips(torch.from_numpy(cot), K1[::-1], K1[::-1], adj, adj, rows=4)
    tol = BLUR_TOL * max(1.0, want.abs().max().item())
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= tol
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda v: jpk.blur4(v, K1, K1, pads, pads), jnp.asarray(x))
        jdx = np.asarray(vjp(jnp.asarray(cot))[0])
    np.testing.assert_allclose(got.numpy(), jdx, atol=tol)


# ---------------------------------------------------------------------------
# (b) the tiled vgg_slice1 forward, conv2 as three TF32 products
# ---------------------------------------------------------------------------

_JAX_A2 = {}


def _slice_inputs(h, w):
    return (_rand((2, h, w, 3), 60), _rand((3, 3, 3, 64), 61, scale=np.sqrt(2.0 / 27)),
            _rand((64,), 62, scale=0.1), _rand((3, 3, 64, 64), 63, scale=np.sqrt(2.0 / 576)),
            _rand((64,), 64, scale=0.1))


def _jax_slice1(h, w):
    """The JAX package's vgg_slice1 (interpret mode), once per size."""
    if (h, w) not in _JAX_A2:
        with pltpu.force_tpu_interpret_mode():
            _JAX_A2[(h, w)] = np.asarray(jslice.vgg_slice1(*[jnp.asarray(a) for a in _slice_inputs(h, w)]))
    return _JAX_A2[(h, w)]


# the float32 kernel's 8 x 16 tile, an odd one, and the bf16 kernel's 16 x 16 (last: ragged)
@pytest.mark.parametrize("h,w,tile", [(13, 22, (8, 16)), (13, 22, (5, 7)), (16, 16, (8, 16)), (16, 16, (16, 16)),
                                      (13, 22, vgg_slice_cuda.FWD_TILE_BF16)])
def test_tiled_slice1_forward_matches_plain_and_jax(h, w, tile):
    args = [torch.from_numpy(a) for a in _slice_inputs(h, w)]
    want = vgg_slice_cuda.vgg_slice1_plain(*args)
    got = vgg_slice_cuda.vgg_slice1_forward_tiled(*args, tile=tile)
    # 2e-5 x scale: the split drops a_lo*b_lo (~2^-22 per product) and three float32
    # convolutions over K = 576 terms are added, each summed in its own order
    tol = 2e-5 * max(1.0, want.abs().max().item())
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= tol
    np.testing.assert_allclose(got.numpy(), _jax_slice1(h, w), atol=tol)


# ---------------------------------------------------------------------------
# (c) counts of the blur4 adjoint shapes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("c,h", roofline.BLUR4_SHAPES)
def test_blur4_adjoint_counts(c, h):
    """Input [n, h, h, c], pads (2, 2), output (h + 1)^2: the forward's bytes (its
    input and output trade places) and 16 taps for each of the larger side's elements."""
    n = 16
    adj = roofline.blur4(n, c, h + 1, h + 1, (2, 2))
    fwd = roofline.blur4(n, c, h, h)
    assert adj["bytes"] == fwd["bytes"] == 4.0 * n * c * (h * h + (h + 1) * (h + 1))
    assert adj["flops"] == 2.0 * 16 * n * (h + 1) * (h + 1) * c
    assert adj["bound_by"] == "bytes"
    assert adj["bound_ms"] == pytest.approx(1e3 * adj["bytes"] / roofline.PEAK_BYTES)
    label, counts = roofline.main_path("blur4_adj", n)[roofline.BLUR4_SHAPES.index((c, h))]
    assert label == f"C{c}_H{h}_adj" and counts == adj


@pytest.mark.parametrize("h", roofline.UPBLUR4_SHAPES)
def test_upblur4_fused_and_adjoint_counts(h):
    """The fused forward reads skip and rgb once and writes the sum once, with one
    add on top of the 4 live taps an output; the adjoint reads the (2h)^2 cotangent
    once, writes h^2, and takes 16 taps for each of those."""
    n, c = 16, 3
    outs = n * c * 4 * h * h
    plain, fused, adj = (roofline.upblur4(n, c, h, h), roofline.upblur4(n, c, h, h, fused=True),
                         roofline.upblur4_adj(n, c, h, h))
    assert plain["bytes"] == 4.0 * (outs // 4 + outs) and plain["flops"] == 8.0 * outs
    assert fused["bytes"] == plain["bytes"] + 4.0 * outs and fused["flops"] == 9.0 * outs
    assert adj["bytes"] == plain["bytes"] and adj["flops"] == 2.0 * 16 * (outs // 4)
    for counts in (plain, fused, adj):
        assert counts["bound_by"] == "bytes"
        assert counts["bound_ms"] == pytest.approx(1e3 * counts["bytes"] / roofline.PEAK_BYTES)
    i = roofline.UPBLUR4_SHAPES.index(h)
    assert roofline.main_path("upblur4", n)[i] == (f"C3_H{h}", fused)
    assert roofline.main_path("upblur4_adj", n)[i] == (f"C3_H{h}", adj)
    assert roofline.LAUNCHES_PER_STEP["upblur4"] == roofline.LAUNCHES_PER_STEP["upblur4_adj"] == 6


# A solve step's launches at 256 px (the tables the card runs are held to) and at
# 1024 px (StyleGAN2 config-f: 8 upsample blocks; LPIPS on the 1024^2 image; in bf16
# the cotangent cascade sends its two widest levels alone first), with gradient
# checkpointing: remat re-runs each block's forward blur4, remat_lpips LPIPS's forward;
# the LPIPS distance head, outside the checkpoint, once each way for each of the five slices.
STEP_LAUNCHES = [
    ("float32", 256, False, False, dict(blur4=12, upblur4=6, upblur4_adj=6, conv3x3_relu=16, vgg_slice1_fwd=1,
                                        vgg_slice1_bwd=1, lpips_head_fwd=5, lpips_head_bwd=5)),
    ("bfloat16", 256, False, False, dict(blur4=12, upblur4=1, upblur4_adj=1, conv3x3_relu=16, vgg_slice1_fwd=1,
                                         vgg_slice1_bwd=1, lpips_head_fwd=5, lpips_head_bwd=5)),
    ("float32", 1024, False, False, dict(blur4=16, upblur4=8, upblur4_adj=8, conv3x3_relu=16, vgg_slice1_fwd=1,
                                         vgg_slice1_bwd=1, lpips_head_fwd=5, lpips_head_bwd=5)),
    ("bfloat16", 1024, False, False, dict(blur4=16, upblur4=1, upblur4_adj=3, conv3x3_relu=16, vgg_slice1_fwd=1,
                                          vgg_slice1_bwd=1, lpips_head_fwd=5, lpips_head_bwd=5)),
    ("float32", 1024, True, False, dict(blur4=24, upblur4=8, upblur4_adj=8, conv3x3_relu=16, vgg_slice1_fwd=1,
                                        vgg_slice1_bwd=1, lpips_head_fwd=5, lpips_head_bwd=5)),
    ("bfloat16", 1024, True, True, dict(blur4=24, upblur4=1, upblur4_adj=3, conv3x3_relu=24, vgg_slice1_fwd=2,
                                        vgg_slice1_bwd=1, lpips_head_fwd=5, lpips_head_bwd=5)),
]


@pytest.mark.parametrize("dtype,img,remat,remat_lpips,want", STEP_LAUNCHES)
def test_step_launches_at_256_and_1024(dtype, img, remat, remat_lpips, want):
    sfx = "_bf16" if dtype == "bfloat16" else ""
    assert roofline.step_launches(dtype, img, remat, remat_lpips) == {k + sfx: v for k, v in want.items()}
    if img == 256 and not remat:
        assert roofline.step_launches(dtype) == roofline.step_launches(dtype, 256)
        assert dtype == "bfloat16" or roofline.LAUNCHES_PER_STEP == want
    n = roofline.chain_levels(img)
    assert len(roofline.blur4_shapes(img)) == len(roofline.upblur4_shapes(img)) == n
    if dtype == "bfloat16":
        assert want["upblur4_adj"] == 1 + upfirdn2d_cuda.adj_chain_split(4, 4, 3, n)


@pytest.mark.parametrize("img", [256, 512, 1024])
def test_main_path_shapes_follow_the_channel_map(img):
    """blur4 at (C_r, r) for r = 8 .. img_size with config-f's C_r (512 up to 64 px,
    then halving as r doubles), so from 64 px on every level moves twice the
    bytes of the one below; the skip chain's inputs 4 .. img_size / 2; LPIPS's
    square convs at img_size / 2 .. img_size / 16 and slice 1 on the image, so
    their bytes grow with the pixels.  At 256 px: the constants."""
    n = 2
    shapes = roofline.blur4_shapes(img)
    assert [h for _, h in shapes] == [2 ** k for k in range(3, int(np.log2(img)) + 1)]
    assert [c for c, _ in shapes] == [min(512, 32768 // h) for _, h in shapes]
    fwd = dict(roofline.main_path("blur4", n, img_size=img))
    for (c0, h0), (c1, h1) in zip(shapes, shapes[1:]):
        b0, b1 = fwd[f"C{c0}_H{h0}"]["bytes"], fwd[f"C{c1}_H{h1}"]["bytes"]
        assert b1 == 4.0 * n * c1 * (h1 * h1 + (h1 + 1) ** 2)
        if h1 > 64:
            assert b1 / b0 == pytest.approx(2.0, rel=0.02)
    assert roofline.upblur4_shapes(img) == tuple(2 ** k for k in range(2, int(np.log2(img))))
    assert [(c, h) for c, h, _ in roofline.conv3x3_shapes(img)] == [(128, img // 2), (256, img // 4),
                                                                    (512, img // 8), (512, img // 16)]
    small, big = roofline.main_path("conv3x3_relu", n), roofline.main_path("conv3x3_relu", n, img_size=img)
    for (_, a), (_, b) in zip(small, big):
        act = (img // 256) ** 2  # activations scale with the pixels; the weights stay
        assert b["flops"] == a["flops"] * act
    (label, s1), = roofline.main_path("vgg_slice1_fwd", n, img_size=img)
    assert label == f"C3_H{img}" and s1 == roofline.slice1_fwd(n, img, img)
    if img == 256:
        assert (shapes, roofline.upblur4_shapes(img), roofline.conv3x3_shapes(img)) == (
            roofline.BLUR4_SHAPES, roofline.UPBLUR4_SHAPES, roofline.CONV3X3_SHAPES)
        assert roofline.SLICE1_H == 256


# ---------------------------------------------------------------------------
# (d) library entry points run on the card unless asked for the CPU
# ---------------------------------------------------------------------------


def test_build_pipeline_defaults_to_cuda_and_never_falls_back():
    """build_pipeline, and sample_batch of the training data, raise without CUDA
    unless asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("with a CUDA device the default builds on it (chip_smoke.py drives that)")
    mcfg = ModelConfig(img_size=8, style_dim=16, n_mlp=1, channel_max=16)
    fpcfg = FingerprintConfig(key_len=4, shift=8, n_pca_samples=100)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.build_pipeline(mcfg, fpcfg)
    pipe = pipeline.build_pipeline(mcfg, fpcfg, device="cpu", want_lpips=False)
    assert pipe.device.type == "cpu" and pipe.noise[0].device.type == "cpu"
    # the training data's render follows the same rule
    with pytest.raises(RuntimeError, match="no CUDA device"):
        data.sample_batch(torch.Generator().manual_seed(0), 2, 8)
    assert data.sample_batch(torch.Generator().manual_seed(0), 2, 8, device="cpu").device.type == "cpu"
