"""PyTorch port ops vs the JAX package on the CPU: upfirdn2d, the FIR kernels'
plain versions, fused_leaky_relu and maxpool2x2.

The same numpy inputs go through both.  The JAX Pallas kernels run in TPU
interpret mode, as the JAX package's own tests run them.  Tolerance for every
FIR and the pool: 1e-5 absolute on O(1) float32 values (a handful of taps,
summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.ops import fused_act as jfa
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.ops import pool as jpool
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.ops import upfirdn2d_pallas as jpk
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.ops.upfirdn2d import (
    upfirdn2d as jupfirdn2d,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.ops import (
    fused_act,
    pool,
    upfirdn2d_cuda,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.ops.upfirdn2d import (
    make_kernel,
    split_symmetric_4tap,
    upfirdn2d,
    upsample2x,
)

ATOL = 1e-5


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize(
    "kernel,up,down,pad",
    [
        ((1, 3, 3, 1), 1, 1, (1, 1)),
        ((1, 3, 3, 1), 2, 1, (2, 1)),
        ((1, 3, 3, 1), 1, 2, (1, 1)),
        ((1, 2, 1), 2, 2, (-1, 2)),
        ((1, 3, 3, 1), 1, 1, (-1, 0, 2, -2)),
        ((1, 2, 3, 4), 3, 1, (0, 1)),
    ],
)
def test_upfirdn2d_matches_jax(kernel, up, down, pad):
    x = _rand((2, 9, 10, 5), 0)
    k = make_kernel(kernel)
    want = np.asarray(jupfirdn2d(jnp.asarray(x), k, up=up, down=down, pad=pad))
    got = upfirdn2d(torch.from_numpy(x), k, up=up, down=down, pad=pad).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_upsample2x_shape_and_values():
    x = _rand((1, 4, 4, 3), 1)
    k = make_kernel((1, 3, 3, 1)) * 4.0
    want = np.asarray(jupfirdn2d(jnp.asarray(x), k, up=2, pad=(2, 1)))
    got = upsample2x(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def _torch_grad(fn, x, cot):
    xt = torch.from_numpy(x).requires_grad_(True)
    y = fn(xt)
    (y * torch.from_numpy(cot)).sum().backward()
    return y.detach().numpy(), xt.grad.numpy()


def _jax_grad(fn, x, cot):
    y, vjp = jax.vjp(fn, jnp.asarray(x))
    return np.asarray(y), np.asarray(vjp(jnp.asarray(cot))[0])


@pytest.mark.parametrize("c", [8, 3])
@pytest.mark.parametrize("pads", [((1, 1), (1, 1)), ((2, 1), (2, 1)), ((2, 2), (0, 3))])
def test_blur4_plain_matches_pallas(c, pads):
    k1 = split_symmetric_4tap(make_kernel((1, 3, 3, 1)) * 4.0)
    (py0, py1), (px0, px1) = pads
    x = _rand((2, 17, 17, c), 2)
    oh, ow = 17 + py0 + py1 - 3, 17 + px0 + px1 - 3
    cot = _rand((2, oh, ow, c), 3)
    with pltpu.force_tpu_interpret_mode():
        jy, jdx = _jax_grad(lambda v: jpk.blur4(v, k1, k1, (py0, py1), (px0, px1)), x, cot)
    ty, tdx = _torch_grad(
        lambda v: upfirdn2d_cuda.blur4(v, k1, k1, (py0, py1), (px0, px1)), x, cot
    )
    np.testing.assert_allclose(ty, jy, atol=ATOL)
    np.testing.assert_allclose(tdx, jdx, atol=ATOL)


@pytest.mark.parametrize("c", [8, 3])
@pytest.mark.parametrize("taps", [(1, 3, 3, 1), (1, 2, 3, 4)])
def test_upblur4_plain_matches_pallas(c, taps):
    k1 = split_symmetric_4tap(make_kernel(taps) * 4.0)
    x = _rand((2, 8, 8, c), 4)
    cot = _rand((2, 16, 16, c), 5)
    with pltpu.force_tpu_interpret_mode():
        jy, jdx = _jax_grad(lambda v: jpk.upblur4(v, k1), x, cot)
    ty, tdx = _torch_grad(lambda v: upfirdn2d_cuda.upblur4(v, k1), x, cot)
    np.testing.assert_allclose(ty, jy, atol=ATOL)
    np.testing.assert_allclose(tdx, jdx, atol=ATOL)


def test_upblur4_adjoint_is_the_kernels_transpose():
    """<upblur4(x), g> == <x, adjoint(g)>: the CUDA path's plain backward."""
    k1 = split_symmetric_4tap(make_kernel((1, 3, 3, 1)) * 4.0)
    x = torch.from_numpy(_rand((1, 6, 6, 3), 6))
    g = torch.from_numpy(_rand((1, 12, 12, 3), 7))
    lhs = (upfirdn2d_cuda.upblur4_plain(x, k1) * g).sum()
    rhs = (x * upfirdn2d_cuda.upblur4_adjoint_plain(g, k1)).sum()
    np.testing.assert_allclose(lhs.item(), rhs.item(), rtol=1e-5)


@pytest.mark.parametrize("c", [3, 7])
@pytest.mark.parametrize("taps", [(1, 3, 3, 1), (1, 2, 3, 4)])
def test_upblur4_add_and_adjoint_plain_match_pallas(c, taps):
    """The fused ``rgb + upblur4(skip)`` and the adjoint's plain version against the
    JAX ``upblur4`` (interpret mode) and its ``_upblur4_bwd``; with (1, 2, 3, 4) the
    taps are not palindromic, so a missing flip would show."""
    k1 = split_symmetric_4tap(make_kernel(taps) * 4.0)
    x, rgb, cot = _rand((2, 6, 8, c), 20), _rand((2, 12, 16, c), 21), _rand((2, 12, 16, c), 22)
    with pltpu.force_tpu_interpret_mode():
        jy, jdx = _jax_grad(lambda v: jnp.asarray(rgb) + jpk.upblur4(v, k1), x, cot)
    jadj = np.asarray(jpk._upblur4_bwd(k1, None, jnp.asarray(cot))[0])
    xt = torch.from_numpy(x).requires_grad_(True)
    rt = torch.from_numpy(rgb).requires_grad_(True)
    y = upfirdn2d_cuda.upblur4_add(rt, xt, k1)
    dx, drgb = torch.autograd.grad(y, [xt, rt], torch.from_numpy(cot))
    np.testing.assert_allclose(y.detach().numpy(), jy, atol=ATOL)
    np.testing.assert_allclose(dx.numpy(), jdx, atol=ATOL)
    np.testing.assert_array_equal(drgb.numpy(), cot)
    adj = upfirdn2d_cuda.upblur4_adjoint_plain(torch.from_numpy(cot), k1).numpy()
    np.testing.assert_allclose(adj, jadj, atol=ATOL)
    np.testing.assert_allclose(adj, dx.numpy(), atol=ATOL)


def test_upsample2x_add_equals_the_two_step_path():
    from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.ops.upfirdn2d import (
        upsample2x_add,
    )

    skip, rgb = torch.from_numpy(_rand((2, 4, 4, 3), 23)), torch.from_numpy(_rand((2, 8, 8, 3), 24))
    for kernel in ((1, 3, 3, 1), (1, 2, 1)):  # the 4-tap kernel's fused pass, and the general path
        want = rgb + upsample2x(skip, kernel)
        np.testing.assert_allclose(upsample2x_add(rgb, skip, kernel).numpy(), want.numpy(), atol=1e-6)


def test_to_rgb_through_the_fused_skip_equals_the_two_step_path():
    """ToRGB = modulated 1x1 conv + bias, then ``+ upsample2x(skip)``: through the
    fused function, values and the gradients to x, the latent and the skip are
    those of the two steps written out."""
    from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.models import (
        stylegan2 as sg2,
    )

    p = sg2._init_to_rgb(torch.Generator().manual_seed(0), 8, 16)
    p["bias"] = torch.tensor([0.1, -0.2, 0.3])
    x, w, skip = (torch.from_numpy(_rand(sh, 30 + i)).requires_grad_(True)
                  for i, sh in enumerate(((2, 8, 8, 8), (2, 16), (2, 4, 4, 3))))
    cot = torch.from_numpy(_rand((2, 8, 8, 3), 33))
    got = sg2.to_rgb(x, w, p, skip)
    want = sg2.modulated_conv2d(x, w, p, demodulate=False) + p["bias"] + upsample2x(skip)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), atol=1e-6)
    for a, b in zip(torch.autograd.grad(got, [x, w, skip], cot), torch.autograd.grad(want, [x, w, skip], cot)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
    no_skip = sg2.to_rgb(x, w, p, None)
    assert no_skip.shape == (2, 8, 8, 3)


def test_fused_leaky_relu_matches_jax():
    x = _rand((2, 4, 4, 6), 8)
    b = _rand((6,), 9)
    want = np.asarray(jfa.fused_leaky_relu(jnp.asarray(x), jnp.asarray(b)))
    got = fused_act.fused_leaky_relu(torch.from_numpy(x), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_maxpool2x2_matches_jax_with_ties():
    x = _rand((2, 6, 8, 4), 10)
    x[0, 0:2, 0:2, 0] = 1.5  # a 4-way tie
    x[1, 2, 2:4, 1] = 2.5  # a 2-way tie (rest of the window below it)
    x[1, 3, 2:4, 1] = -3.0
    cot = _rand((2, 3, 4, 4), 11)
    jy, jdx = _jax_grad(jpool.maxpool2x2, x, cot)
    ty, tdx = _torch_grad(pool.maxpool2x2, x, cot)
    np.testing.assert_allclose(ty, jy, atol=ATOL)
    np.testing.assert_allclose(tdx, jdx, atol=ATOL)
    np.testing.assert_allclose(tdx[0, 0:2, 0:2, 0], cot[0, 0, 0, 0] / 4, atol=ATOL)
    np.testing.assert_allclose(tdx[1, 2, 2:4, 1], cot[1, 1, 1, 1] / 2, atol=ATOL)


def test_kernel_wrappers_refuse_non_float32_on_cuda_path():
    """The CUDA launchers check dtype before anything reaches the card: float32
    and bfloat16 pass the dtype check (and are then refused here only for lying
    on the CPU); float16, float64 and a launch that mixes dtypes are refused."""
    from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.ops._cuda import (
        check_cuda_operands,
    )

    for dtype in (torch.float16, torch.float64):
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            check_cuda_operands("blur4", torch.zeros(1, 4, 4, 8, dtype=dtype))
    with pytest.raises(TypeError, match="operands of one launch"):
        check_cuda_operands("upblur4", torch.zeros(1, 4, 4, 3, dtype=torch.bfloat16), torch.zeros(1, 8, 8, 3))
    for dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="CUDA tensor"):
            check_cuda_operands("blur4", torch.zeros(1, 4, 4, 8, dtype=dtype))
