"""The plain versions of the port's VGG kernels (conv3x3_relu, vgg_slice1) vs
the JAX package's Pallas kernels, run in TPU interpret mode on the CPU.

Forward and dx at [2, 16, 16, C].  Tolerance 1e-4 relative to the output's
scale: float32 sums over 9*C (up to 576) terms taken in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.ops import vgg_pallas as jvgg
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.ops import (
    vgg_slice_pallas as jslice,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.ops import (
    vgg_cuda,
    vgg_slice_cuda,
)

RTOL = 1e-4


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got, want, atol=RTOL * max(1.0, float(np.abs(want).max())))


def _both(jfn, tfn, args, cot):
    """(forward, d/d arg0) from JAX (interpret mode) and from torch."""
    with pltpu.force_tpu_interpret_mode():
        jy, vjp = jax.vjp(jfn, *[jnp.asarray(a) for a in args])
        jdx = vjp(jnp.asarray(cot))[0]
    targs = [torch.from_numpy(a) for a in args]
    targs[0].requires_grad_(True)
    ty = tfn(*targs)
    (ty * torch.from_numpy(cot)).sum().backward()
    return (np.asarray(jy), np.asarray(jdx)), (ty.detach().numpy(), targs[0].grad.numpy())


@pytest.mark.parametrize("c", [64])
def test_conv3x3_relu_plain_matches_pallas(c):
    x = _rand((2, 16, 16, c), 0)
    w = _rand((3, 3, c, c), 1, scale=np.sqrt(2.0 / (9 * c)))
    b = _rand((c,), 2, scale=0.1)
    cot = _rand((2, 16, 16, c), 3)
    (jy, jdx), (ty, tdx) = _both(jvgg.conv3x3_relu, vgg_cuda.conv3x3_relu, (x, w, b), cot)
    _close(ty, jy)
    _close(tdx, jdx)


def test_vgg_slice1_plain_matches_pallas():
    x = _rand((2, 16, 16, 3), 4)
    w1 = _rand((3, 3, 3, 64), 5, scale=np.sqrt(2.0 / 27))
    b1 = _rand((64,), 6, scale=0.1)
    w2 = _rand((3, 3, 64, 64), 7, scale=np.sqrt(2.0 / 576))
    b2 = _rand((64,), 8, scale=0.1)
    cot = _rand((2, 16, 16, 64), 9)
    (jy, jdx), (ty, tdx) = _both(
        jslice.vgg_slice1, vgg_slice_cuda.vgg_slice1, (x, w1, b1, w2, b2), cot
    )
    _close(ty, jy)
    _close(tdx, jdx)


def test_flip_io_is_the_adjoint_conv():
    """<conv(x, w), g> == <x, conv(g, flip_io(w))>: the weights the dx launch uses."""
    x = torch.from_numpy(_rand((1, 6, 6, 4), 10))
    g = torch.from_numpy(_rand((1, 6, 6, 5), 11))
    w = torch.from_numpy(_rand((3, 3, 4, 5), 12))
    lhs = (vgg_cuda.conv3x3_plain(x, w) * g).sum()
    rhs = (x * vgg_cuda.conv3x3_plain(g, vgg_cuda.flip_io(w))).sum()
    np.testing.assert_allclose(lhs.item(), rhs.item(), rtol=1e-4)
