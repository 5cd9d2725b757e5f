"""The ToRGB skip chain as one op (``ops/upfirdn2d.py::upsample2x_chain``) on
the CPU: against the JAX package's skip chain, the forward kernel's tile walk
against the plain chain, the chain's autograd Functions wired as on the card,
and its bounds and launch tables.

The JAX chain is ``to_rgb``'s ``y + upsample2x(skip)`` level by level, with
``upblur4`` run in TPU interpret mode as ``tests/test_torch_ops.py`` runs it.
Tolerances: float32 within 1e-5 of max|JAX| (a handful of taps summed in
another order); bfloat16 within 0.03 of max|JAX| (JAX rounds the upsample and
then the add to bf16, the port rounds each level's sum once).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.ops import upfirdn2d_pallas as jpk
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.ops import roofline, upfirdn2d_cuda
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.ops.upfirdn2d import (
    make_kernel,
    split_symmetric_4tap,
    upsample2x_chain,
)

K1 = split_symmetric_4tap(make_kernel((1, 3, 3, 1)) * 4.0)
K_SKEW = split_symmetric_4tap(make_kernel((1, 2, 3, 4)) * 4.0)  # not a palindrome: a missing flip shows
# not a palindrome either, and every product of two taps exact in float32, as the plain
# version's 2-D taps are: the walk and the plain chain then differ by summation order only
K_DYADIC = (0.25, 0.5, 0.75, 1.0)


def _levels(n, h0, w0, c, levels, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((n, h0 << k, w0 << k, c)).astype(np.float32) for k in range(levels + 1)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_upsample2x_chain_and_its_vjp_match_jax(dtype):
    """Batch 2, 4^2 -> 32^2, C = 3: rgb_3 and the cotangents of t_0 .. t_3."""
    ts = _levels(2, 4, 4, 3, 3, 0)
    cot = np.random.default_rng(1).standard_normal(ts[-1].shape).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32

    def jchain(*levels):
        rgb = levels[0]
        for t in levels[1:]:
            rgb = t + jpk.upblur4(rgb, K1)
        return rgb

    with pltpu.force_tpu_interpret_mode():
        jy, vjp = jax.vjp(jchain, *[jnp.asarray(t, jdt) for t in ts])
        jgrads = vjp(jnp.asarray(cot, jdt))
    tts = [torch.from_numpy(t).to(tdt).requires_grad_(True) for t in ts]
    y = upsample2x_chain(tts)
    tgrads = torch.autograd.grad(y, tts, torch.from_numpy(cot).to(tdt))
    assert y.dtype == tdt and y.shape == jy.shape
    for got, want in [(y, jy), *zip(tgrads, jgrads)]:
        want = np.asarray(want, np.float32)
        err = np.abs(got.detach().float().numpy() - want).max()
        assert err <= (1e-5 if dtype == "float32" else 0.03) * np.abs(want).max(), err


# (levels as N, H0, W0, C, L; tile): the main path's C = 3 from 4^2 at the kernel's own
# tile and at tiles that clip every level's region; non-square, non-power-of-two levels
# with C = 4 and C = 1, where a tile's region meets the image edge at every level
TILE_CASES = [((2, 4, 4, 3, 3), upfirdn2d_cuda.CHAIN_TILE), ((2, 4, 4, 3, 3), (5, 3)),
              ((1, 3, 5, 4, 3), (4, 8)), ((1, 5, 3, 1, 2), (1, 1))]


@pytest.mark.parametrize("shape,tile", TILE_CASES)
def test_chain_tile_walk_matches_the_plain_chain(shape, tile):
    """The forward kernel's walk (tiles of the top level, each computed upward
    through the regions ``chain_span`` gives, NaN outside them) equals the plain
    chain in float64, with the taps not palindromic: a halo one row short leaves
    a NaN, a wrong tap parity a difference."""
    ts = [torch.from_numpy(t).double() for t in _levels(*shape, 2)]
    want = upfirdn2d_cuda.upblur4_chain_plain(ts, K_DYADIC)
    got = upfirdn2d_cuda.upblur4_chain_tiles(ts, K_DYADIC, tile)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 1e-12
    # and with no add at the top: the cascade's own backward
    want = upfirdn2d_cuda.upblur4_chain_plain(ts[:-1] + [None], K_DYADIC)
    assert (upfirdn2d_cuda.upblur4_chain_tiles(ts[:-1] + [None], K_DYADIC, tile) - want).abs().max().item() <= 1e-12


def _opaque(fn):
    """A plain version run as autograd sees a kernel launch: no graph."""
    def launch(*args):
        with torch.no_grad():
            return fn(*args)
    return launch


def test_chain_functions_are_twice_differentiable(monkeypatch):
    """``_Upblur4Chain`` / ``_Upblur4AdjChain`` wired as on the card, their
    launches swapped for the plain chains in float64 (opaque to autograd like a
    kernel): gradcheck and gradgradcheck of the chain, and the cascade's
    cotangents equal the plain adjoint's."""
    monkeypatch.setattr(upfirdn2d_cuda, "upblur4_chain_launch", _opaque(upfirdn2d_cuda.upblur4_chain_plain))
    monkeypatch.setattr(upfirdn2d_cuda, "upblur4_adj_chain_launch",
                        _opaque(lambda g, k, levels: upfirdn2d_cuda.upblur4_adj_chain_plain(g, k, levels)[:-1]))
    ts = [torch.from_numpy(t).double().requires_grad_(True) for t in _levels(1, 1, 2, 1, 2, 3)]

    def chain(*levels):
        return upfirdn2d_cuda._Upblur4Chain.apply(K_SKEW, *levels)

    assert torch.autograd.gradcheck(chain, tuple(ts))
    assert torch.autograd.gradgradcheck(chain, tuple(ts))
    g = torch.randn((1, 4, 8, 1), generator=torch.Generator().manual_seed(4), dtype=torch.float64)
    got = torch.autograd.grad(chain(*ts), ts, g)
    want = upfirdn2d_cuda.upblur4_adj_chain_plain(g, K_SKEW, 2)
    for a, b in zip(got, want):
        assert torch.allclose(a, b, rtol=0, atol=1e-12)
    assert got[-1] is not None and torch.equal(got[-1], g)


def test_chain_bounds_launch_tables_and_cascade_split():
    """At 256 px, batch 16, bf16: the forward chain reads t_0 .. t_6 (8.39 MB)
    and writes the image (6.29 MB), a 4.4 us byte bound; the cascade reads g
    (6.29 MB) and writes g_0 .. g_5 (2.10 MB), 2.5 us.  A bf16 solve step
    launches each once, float32 six times.  The cascade's shared memory holds a
    256 px chain whole; 512 and 1024 px go with one and two leading levels
    alone."""
    fwd, adj = roofline.upblur4_chain(16, 3, 4, 6, "bfloat16"), roofline.upblur4_adj_chain(16, 3, 4, 6, "bfloat16")
    t_bytes = 2 * 16 * 3 * sum(16 * 4 ** k for k in range(7))
    assert fwd["bytes"] == t_bytes + 2 * 16 * 3 * 256 ** 2 and round(fwd["bytes"] / 1e6, 2) == 14.68
    assert adj["bytes"] == 2 * 16 * 3 * (256 ** 2 + sum(16 * 4 ** k for k in range(6)))
    assert round(fwd["bound_ms"] * 1e3, 1) == 4.4 and round(adj["bound_ms"] * 1e3, 1) == 2.5
    assert fwd["bound_by"] == adj["bound_by"] == "bytes"
    assert roofline.main_path("upblur4_chain", 16, "bfloat16") == [("C3_H4-H256", fwd)]
    assert roofline.main_path("upblur4_adj_chain", 16, "bfloat16") == [("C3_H4-H256", adj)]
    assert roofline.step_launches("bfloat16")["upblur4_bf16"] == roofline.step_launches("bfloat16")[
        "upblur4_adj_bf16"] == 1
    assert roofline.step_launches()["upblur4"] == roofline.step_launches()["upblur4_adj"] == 6
    assert [upfirdn2d_cuda.adj_chain_split(4, 4, 3, lv) for lv in (6, 7, 8)] == [0, 1, 2]
    assert upfirdn2d_cuda.adj_cascade_smem(4, 4, 3, 6) <= upfirdn2d_cuda.CHAIN_SMEM_MAX
