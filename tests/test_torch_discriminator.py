"""The port's discriminator, R1 term, FIR double backward and style mixing
against the JAX package on the CPU.

The JAX training tests' tiny configuration (16px, style_dim 32, n_mlp 2,
channel_max 32), weights drawn by the JAX package and carried over by
``discriminator_params_from_jax`` / ``params_from_jax``; images and latents
from numpy.  oneDNN's convolutions are off (as in the solver's parity tests):
with them the float32 gradients sit several times further from a float64
evaluation than PyTorch's direct convs and the JAX package do.  Tolerance:
1e-4 of each compared array's largest magnitude (float32 sums in another
order through up to 7 conv layers, and a second derivative for R1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.config import (
    ModelConfig as JModelConfig,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.fingerprint import (
    pipeline as jpl,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.models import (
    stylegan2 as jsg2,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.checkpoints import (
    flat as jflat,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.ops.upfirdn2d import (
    downsample2x as jdownsample2x,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.checkpoints import flat
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.checkpoints import (
    rosinality,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.config import ModelConfig
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.fingerprint import (
    pipeline as pl,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.models import (
    stylegan2 as sg2,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.ops import (
    upfirdn2d as up,
    upfirdn2d_cuda,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.utils.tree import tree_leaves

KW = dict(img_size=16, style_dim=32, n_mlp=2, channel_max=32)
JCFG, CFG = JModelConfig(**KW), ModelConfig(**KW)
R1, D_REG_EVERY = 10.0, 2
TOL = 1e-4


def _close(got, want, tol=TOL, msg=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, msg
    np.testing.assert_allclose(got, want, atol=tol * max(1.0, float(np.abs(want).max())), err_msg=msg)


@pytest.fixture
def direct_cpu_convs():
    before = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    yield
    torch.backends.mkldnn.enabled = before


def _to_jax(tree):
    return jax.tree.map(lambda v: jnp.asarray(v.numpy()), tree)


@pytest.fixture(scope="module")
def jd():
    """Discriminator weights as a JAX tree (drawn by the port's initializer,
    which draws the JAX package's distributions), with non-zero biases so
    every term of each layer is exercised."""
    p = flat.flatten_params(sg2.init_discriminator_params(CFG, torch.Generator().manual_seed(4), "cpu"))
    rng = np.random.default_rng(5)
    return jflat.unflatten_params({k: jnp.asarray(rng.standard_normal(v.shape).astype(np.float32) * 0.1
                                                  if k.endswith("bias") else v) for k, v in p.items()})


def test_downsample2x_matches_jax():
    x = np.random.default_rng(0).standard_normal((2, 9, 12, 5)).astype(np.float32)
    want = np.asarray(jdownsample2x(jnp.asarray(x)))
    got = up.downsample2x(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 4, 6, 5)
    _close(got, want)


def test_discriminator_forward_input_grad_and_r1_match_jax(jd, direct_cpu_convs):
    """D(x), d sum D / dx, the lazy R1 term at d_reg_every = 2 and its gradient
    in every D parameter (a second derivative through the blurs, the stride-2
    convs and the minibatch stddev), against ``jax.grad`` of the JAX
    package's R1 expression (``training/gan.py``)."""
    x = np.random.default_rng(1).uniform(-1, 1, (4, 16, 16, 3)).astype(np.float32)

    def r1_term(dp, imgs):
        g = jax.grad(lambda i: jnp.sum(jsg2.discriminator_apply(dp, i, JCFG)))(imgs)
        return (R1 / 2.0) * jnp.mean(jnp.sum(jnp.square(g), axis=(1, 2, 3))) * D_REG_EVERY, g

    @jax.jit
    def jax_side(dp, imgs):
        logits = jsg2.discriminator_apply(dp, imgs, JCFG)
        (r1, g), dr1 = jax.value_and_grad(r1_term, has_aux=True)(dp, imgs)
        return logits, g, r1, dr1

    jlogits, jg, jr1, jdr1 = jax_side(jd, jnp.asarray(x))

    dp = rosinality.discriminator_params_from_jax(jd, "cpu")
    leaves = tree_leaves(dp)
    for p in leaves:
        p.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    logits = sg2.discriminator_apply(dp, xt, CFG)
    (g,) = torch.autograd.grad(logits.sum(), xt, create_graph=True)
    r1 = (R1 / 2.0) * g.square().sum(dim=(1, 2, 3)).mean() * D_REG_EVERY
    # final_linear1's bias does not reach d D / dx: no gradient (JAX: zeros)
    dr1 = [torch.zeros_like(p) if d is None else d
           for p, d in zip(leaves, torch.autograd.grad(r1, leaves, allow_unused=True))]

    assert logits.shape == (4, 1)
    _close(logits.detach(), jlogits, msg="logits")
    _close(g.detach(), jg, msg="d sum D / dx")
    np.testing.assert_allclose(r1.item(), float(jr1), rtol=TOL)
    want = jflat.flatten_params(jdr1)
    got = flat.flatten_params(dict(zip(flat.flatten_params(dp), dr1)))
    assert sorted(got) == sorted(want)
    for name in want:
        _close(got[name], want[name], msg=name)


def test_minibatch_stddev_groups_like_jax():
    """Sample i is grouped with i + k * (B / group): B = 8 gives two groups of 4."""
    x = np.random.default_rng(2).standard_normal((8, 4, 4, 3)).astype(np.float32)
    want = np.asarray(jsg2.minibatch_stddev(jnp.asarray(x)))
    got = sg2.minibatch_stddev(torch.from_numpy(x)).numpy()
    _close(got, want)
    assert not np.allclose(got[0, ..., -1], got[1, ..., -1])


def test_init_discriminator_params_structure_matches_jax():
    got = flat.flatten_params(sg2.init_discriminator_params(CFG, torch.Generator().manual_seed(0), "cpu"))
    shapes = jax.eval_shape(lambda k: jsg2.init_discriminator_params(k, JCFG), jax.random.PRNGKey(0))
    want = jflat.flatten_params(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes))
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}


def _opaque(fn):
    """A plain version run as autograd sees a kernel launch: no graph."""
    def launch(*args):
        with torch.no_grad():
            return fn(*args)
    return launch


# the three launch functions as plain versions, in any dtype and opaque to
# autograd like the kernels (the autograd Functions reach them only through these)
PLAIN_LAUNCHES = {
    "blur4_launch": _opaque(lambda x, fy, fx, py, px: upfirdn2d_cuda.blur4_plain(x, fy[::-1], fx[::-1], py, px)),
    "upblur4_launch": _opaque(lambda x, k, rgb=None: upfirdn2d_cuda.upblur4_plain(x, k) + (0 if rgb is None else rgb)),
    "upblur4_adjoint_launch": _opaque(upfirdn2d_cuda.upblur4_adjoint_plain),
}


@pytest.mark.parametrize("case", ["blur4_pad11", "blur4_pad22", "blur4_pad12", "upblur4", "upblur4_add"])
def test_fir_functions_are_twice_differentiable(monkeypatch, case):
    """``_Blur4`` / ``_Upblur4`` wired as on the card (each backward another
    autograd Function), with their launches swapped for the plain versions in
    float64, as opaque to autograd as a kernel: ``gradgradcheck`` holds their
    second derivatives to autograd's numerical ones (a backward that launched
    directly would leave no graph to differentiate)."""
    for name, fn in PLAIN_LAUNCHES.items():
        monkeypatch.setattr(upfirdn2d_cuda, name, fn)
    k = up.split_symmetric_4tap(up.make_kernel((1, 2, 3, 4)) * 4.0)  # not a palindrome: flips show
    g = torch.Generator().manual_seed(0)
    if case.startswith("blur4"):
        pads = {"blur4_pad11": (1, 1), "blur4_pad22": (2, 2), "blur4_pad12": (1, 2)}[case]
        x = torch.randn((1, 4, 5, 2), generator=g, dtype=torch.float64, requires_grad=True)
        fn = lambda v: upfirdn2d_cuda._Blur4.apply(v, k, k[::-1], pads, pads[::-1])  # noqa: E731
        inputs = (x,)
    else:
        x = torch.randn((1, 2, 3, 2), generator=g, dtype=torch.float64, requires_grad=True)
        if case == "upblur4":
            fn = lambda v: upfirdn2d_cuda._Upblur4.apply(v, None, k)  # noqa: E731
            inputs = (x,)
        else:
            rgb = torch.randn((1, 4, 6, 2), generator=g, dtype=torch.float64, requires_grad=True)
            fn = lambda v, r: upfirdn2d_cuda._Upblur4.apply(v, r, k)  # noqa: E731
            inputs = (x, rgb)
    assert torch.autograd.gradcheck(fn, inputs)
    assert torch.autograd.gradgradcheck(fn, inputs)


@pytest.fixture(scope="module")
def jg():
    return _to_jax(sg2.init_generator_params(CFG, torch.Generator().manual_seed(3), "cpu"))


def test_prepare_latent_mixing_and_truncation_match_jax(jg):
    rng = np.random.default_rng(3)
    z1, z2 = (rng.standard_normal((2, 32)).astype(np.float32) for _ in range(2))
    w3 = rng.standard_normal((2, JCFG.n_latent, 32)).astype(np.float32)
    zm = rng.standard_normal((64, 32)).astype(np.float32)
    tg = rosinality.params_from_jax(jg, "cpu")
    t = torch.from_numpy
    mean_j = np.asarray(jax.jit(lambda p, z: jnp.mean(jsg2.mapping_network(p, z, JCFG.lr_mlp), 0, keepdims=True))(
        jg, jnp.asarray(zm)))
    mean_t = sg2.mean_latent(tg, 64, CFG, z=t(zm))
    _close(mean_t, mean_j, msg="mean_latent")
    cases = [
        dict(styles=[z1, z2], kw=dict(inject_index=3)),
        dict(styles=[z1, z2], kw=dict()),
        dict(styles=[z1], kw=dict(truncation=0.7)),
        dict(styles=[z1, z2], kw=dict(truncation=0.5, inject_index=1)),
        dict(styles=[z1, z2], kw=dict(input_is_latent=True, inject_index=2, truncation=0.5)),  # w: no truncation
        dict(styles=[w3], kw=dict(input_is_latent=True)),  # w+ passthrough
    ]
    for c in cases:
        kw = dict(c["kw"])
        want = np.asarray(jsg2.prepare_latent(jg, [jnp.asarray(s) for s in c["styles"]], JCFG,
                                              truncation_latent=jnp.asarray(mean_j), **kw))
        got = sg2.prepare_latent(tg, [t(s) for s in c["styles"]], CFG, truncation_latent=mean_t, **kw)
        assert got.shape == (2, CFG.n_latent, 32)
        _close(got, want, msg=str(c["kw"]))


def test_synthesize_mixed_matches_jax(jg):
    rng = np.random.default_rng(4)
    w0, wx = (rng.standard_normal((2, 32)).astype(np.float32) for _ in range(2))
    noise = [rng.standard_normal(s).astype(np.float32) for s in jsg2.noise_shapes(16)]
    jpipe = jpl.Pipeline(mcfg=JCFG, fpcfg=None, gen_params=jg, basis=None, pca=None,
                         noise=tuple(jnp.asarray(n) for n in noise))
    tpipe = pl.Pipeline(mcfg=CFG, fpcfg=None, gen_params=rosinality.params_from_jax(jg, "cpu"), basis=None, pca=None,
                        noise=[torch.from_numpy(n) for n in noise], device=torch.device("cpu"))
    for inject in (None, 2):
        want = np.asarray(jax.jit(lambda a, b: jpl.synthesize_mixed(jpipe, a, b, inject))(w0, wx))
        got = pl.synthesize_mixed(tpipe, torch.from_numpy(w0), torch.from_numpy(wx), inject)
        _close(got, want, msg=f"inject_index {inject}")
    plain = pl.synthesize(tpipe, torch.from_numpy(w0))
    assert (got - plain).abs().max() > 1e-4  # a mixture, not the content image
