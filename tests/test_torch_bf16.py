"""The port's bfloat16 mode against the JAX package's, on the CPU.

The same numpy inputs and parameters go to both packages; the port's kernel
wrappers run their plain bf16 versions (CPU tensors), the JAX package its
default XLA paths and, for its Pallas kernels, their XLA oracles
(``*_reference``), in bf16.  Every bound is relative to the JAX value's
largest magnitude:

- each kernel's module, bf16 in and out: its output and its VJP within
  0.03, the JAX package's own bound for its bf16 kernels
  (``tests/test_vgg_pallas.py``), the VJP outside ReLU kinks (below);
- synthesis at a tiny configuration with fixed noise, and BigGAN: 0.05;
- one solve step from one state (perceptual and mse): the per-element loss
  0.02 relative; the gradients within 0.05 (``tests/test_lpips.py``'s bf16
  bound) of JAX's bf16 ones and of the port's float32 step's; free-running
  solves drift, so the comparison is step by step;
- the fused distance head: its value rtol 1e-5 (``tests/test_lpips.py``), its
  gradient 0.05;
- the encoder's render through a bf16 w+: 0.03.

The two packages round in other places where XLA fuses (the separable blur's
two passes, a conv's bias, the upsample before its add), so agreement is to
a few bf16 ulps, not bit for bit.  Backward passes add to that: a ReLU whose
bf16 pre-activation lies within rounding of zero switches in one package and
not the other, and each switch moves the gradient by a whole term (0.05-0.08
of max here).  A module's VJP is therefore compared outside the
neighbourhoods of the ReLUs whose masks the two packages set differently:
3x3 pixels around a conv's output, 5x5 around the slice's second ReLU.  Each
bf16 result is also held apart from the float32 one, so that the rounding is
shown to happen.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from test_torch_biggan import CONFIGS, make_params

from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.config import (
    AttributionConfig as JAttributionConfig,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.config import (
    ModelConfig as JModelConfig,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.fingerprint import attribute as jattr
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.fingerprint import embed as jembed
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.losses import lpips as jlp
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.models import biggan as jbg
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.models import stylegan2 as jsg2
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.ops import vgg_pallas as jvgg
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.ops import vgg_slice_pallas as jslice
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.config import (
    AttributionConfig,
    FingerprintConfig,
    ModelConfig,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.fingerprint import attribute as attr
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.fingerprint import embed
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.fingerprint import encoder as enc
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.fingerprint import pipeline as pl
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.losses import lpips
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.models import biggan as bg
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.models import stylegan2 as sg2
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.ops import (
    upfirdn2d,
    vgg_cuda,
    vgg_slice_cuda,
)

jup = importlib.import_module("attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.ops.upfirdn2d")
BF = torch.bfloat16


def _rel(got, want) -> float:
    """max |got - want| / max |want|, in float32."""
    g = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    w = np.asarray(want, np.float32)
    return float(np.abs(g - w).max() / np.abs(w).max())


def _pair(a: np.ndarray):
    """A float32 array rounded to bf16, as a JAX array and a torch tensor."""
    j = jnp.asarray(a).astype(jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(BF)


def _flip_halo(jy, ty, k: int) -> np.ndarray:
    """[N, H, W]: the k x k neighbourhoods of the pixels where the two
    packages' ReLU outputs ``jy`` / ``ty`` ([N, H, W, C]) differ in their
    mask [y > 0] in some channel."""
    flips = (np.asarray(jy, np.float32) > 0) != (ty.detach().float().numpy() > 0)
    t = torch.from_numpy(flips.any(-1).astype(np.float32))[:, None]
    return F.max_pool2d(t, k, stride=1, padding=k // 2)[:, 0].numpy() > 0


def _module_case(name: str, rng):
    """(inputs, JAX function, port function, kinks) of one kernel's module;
    the functions close over float32 parameters, the inputs are rounded to
    bf16.  ``kinks(jx, tx, jout, tout)`` is None for a linear module, else the
    [N, H, W] pixels of dx within reach of a ReLU whose mask the two packages
    set differently."""
    k4 = jup.make_kernel((1, 3, 3, 1)) * 4.0
    if name in ("blur4_fwd", "blur4_adj"):
        pad = (1, 1) if name == "blur4_fwd" else (2, 2)
        return ([rng.standard_normal((2, 9, 9, 16))], lambda x: jup.upfirdn2d(x, k4, pad=pad),
                lambda x: upfirdn2d.upfirdn2d(x, k4, pad=pad), None)
    if name == "upsample2x_add":
        return ([rng.standard_normal((2, 16, 16, 3)), rng.standard_normal((2, 8, 8, 3))],
                lambda rgb, s: rgb + jup.upsample2x(s), upfirdn2d.upsample2x_add, None)
    if name == "conv3x3_relu":
        w = (rng.standard_normal((3, 3, 64, 64)) / 24.0).astype(np.float32)
        b = (rng.standard_normal(64) * 0.1).astype(np.float32)
        tw, tb = torch.from_numpy(w), torch.from_numpy(b)
        return ([rng.standard_normal((2, 8, 8, 64))], lambda x: jvgg.conv3x3_relu_reference(x, w, b),
                lambda x: vgg_cuda.conv3x3_relu(x, tw, tb), lambda jx, tx, jy, ty: _flip_halo(jy, ty, 3))
    ws = [(rng.standard_normal(s) * sc).astype(np.float32)
          for s, sc in (((3, 3, 3, 64), 0.27), ((64,), 0.1), ((3, 3, 64, 64), 0.06), ((64,), 0.1))]
    tws = [torch.from_numpy(w) for w in ws]

    def kinks(jx, tx, jy, ty):
        # relu1_1 reaches dx through conv1 (3x3); the output's ReLU through conv2 and conv1 (5x5)
        a1 = _flip_halo(jvgg.conv3x3_relu_reference(jx, ws[0], ws[1]),
                        vgg_cuda.conv3x3_relu_plain(tx, tws[0], tws[1]), 3)
        return a1 | _flip_halo(jy, ty, 5)

    return ([rng.standard_normal((2, 12, 12, 3))], lambda x: jslice.vgg_slice1_reference(x, *ws),
            lambda x: vgg_slice_cuda.vgg_slice1(x, *tws), kinks)


@pytest.mark.parametrize("name", ["blur4_fwd", "blur4_adj", "upsample2x_add", "conv3x3_relu", "vgg_slice1"])
def test_kernel_modules_in_bf16_match_jax(name):
    """Forward and VJP (every input) of each kernel's module in bf16: within
    0.03 of max, outputs and gradients in bf16 on both sides; dx of a module
    with ReLUs outside the reach of the ReLUs whose masks differ (under 1% of
    them; at least a third of the pixels compared).  The bf16 output stands
    apart from the float32 one on the same inputs by more than 5e-4 of max
    (the two packages agree to ~1e-6 in float32)."""
    rng = np.random.default_rng(len(name))
    inputs, jfn, tfn, kinks = _module_case(name, rng)
    pairs = [_pair(a.astype(np.float32)) for a in inputs]
    jout, vjp = jax.vjp(jfn, *[j for j, _ in pairs])
    jcot, tcot = _pair(rng.standard_normal(jout.shape).astype(np.float32))
    jgrads = vjp(jcot)
    tin = [t.clone().requires_grad_(True) for _, t in pairs]
    tout = tfn(*tin)
    tgrads = torch.autograd.grad(tout, tin, tcot)
    assert jout.dtype == jnp.bfloat16 and tout.dtype == BF
    assert _rel(tout, jout) < 0.03, name
    assert _rel(tout, jfn(*[j.astype(jnp.float32) for j, _ in pairs])) > 5e-4, name
    keep = np.ones(tgrads[0].shape[:-1], bool)
    if kinks is not None:
        assert float(((np.asarray(jout, np.float32) > 0) != (tout.detach().float().numpy() > 0)).mean()) < 0.01
        keep = ~kinks(pairs[0][0], tin[0].detach(), jout, tout)
        assert keep.mean() > 1 / 3, name
    for i, (tg, jg) in enumerate(zip(tgrads, jgrads)):
        assert tg.dtype == BF and jg.dtype == jnp.bfloat16
        mask = keep[..., None] if i == 0 else 1.0
        assert float(np.abs((tg.float().numpy() - np.asarray(jg, np.float32)) * mask).max()
                     / np.abs(np.asarray(jg, np.float32)).max()) < 0.03, name


def test_biggan_generate_with_a_bf16_z_matches_jax():
    """BigGAN's tiny configuration from a bf16 z: as in the JAX package, z is
    widened where it meets the float32 class embedding, so the image is
    float32; within 0.05 of max."""
    cfg, jcfg = bg.BigGANConfig(**CONFIGS["attention"]), jbg.BigGANConfig(**CONFIGS["attention"])
    p, jp = make_params(cfg)
    jz, tz = _pair((np.random.default_rng(1).standard_normal((3, cfg.z_dim)) * 0.4).astype(np.float32))
    onehot = bg.one_hot_from_int(3, cfg.num_classes, 3)
    want = jax.jit(jbg.generate, static_argnums=(3, 4))(jp, jz, jnp.asarray(onehot), 0.4, jcfg)
    got = bg.generate(p, tz, torch.from_numpy(onehot), 0.4, cfg)
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    assert _rel(got, want) < 0.05


def test_fused_head_in_bf16_matches_jax():
    """The solver's distance head on bf16 features against JAX's
    ``_fused_slice_distance``: the float32 value to rtol 1e-5, the bf16
    gradient within 0.05 of max."""
    rng = np.random.default_rng(7)
    jf, tf = _pair(rng.standard_normal((2, 3, 8, 8, 32)).astype(np.float32))
    t = rng.standard_normal((2, 1, 8, 8, 32)).astype(np.float32)
    jt, tt = _pair(t / np.linalg.norm(t, axis=-1, keepdims=True))
    lin = (rng.random(32) / 32).astype(np.float32)

    def jloss(f):
        return jnp.sum(jlp._fused_slice_distance(f, jt, jnp.asarray(lin), 1e-10))

    # the value op by op: under jit XLA may keep fn in float32 (excess precision) where the code rounds it
    jd = jlp._fused_slice_distance(jf, jt, jnp.asarray(lin), 1e-10)
    jg = jax.jit(jax.grad(jloss))(jf)
    f = tf.clone().requires_grad_(True)
    d = lpips._FusedSliceDistance.apply(f, tt, torch.from_numpy(lin), 1e-10)
    (g,) = torch.autograd.grad(d.sum(), f)
    assert d.dtype == torch.float32 and g.dtype == BF and jg.dtype == jnp.bfloat16
    np.testing.assert_allclose(d.detach().numpy(), np.asarray(jd), rtol=1e-5)
    assert _rel(g, jg) < 0.05


MKW = dict(img_size=32, style_dim=64, n_mlp=3, channel_max=64)  # the tiny converging configuration
FKW = dict(key_len=8, shift=56, sigma=1.0, n_pca_samples=1000)
_jsynthesis = jax.jit(jsg2.synthesis)


@pytest.fixture(scope="module")
def problem():
    """The tiny converging configuration built by the port on the CPU (generator,
    LPIPS, basis, noise), two of its fingerprinted images as targets and three
    starts each; the same trees and arrays for the JAX package (the two
    packages share the parameter layout)."""
    pipe = pl.build_pipeline(ModelConfig(**MKW), FingerprintConfig(**FKW), device="cpu",
                             generator=torch.Generator().manual_seed(0))
    imgs = pl.generate_fingerprinted(pipe, 2, torch.Generator().manual_seed(1))[0]
    rng = np.random.default_rng(2)
    a0 = (rng.uniform(-1.0, 1.0, (2, 3, pipe.basis.sigma_rest.shape[0])) * pipe.basis.sigma_rest.numpy())
    to_j = lambda tree: jax.tree.map(lambda v: jnp.asarray(v.numpy()), tree)  # noqa: E731
    jbasis = jembed.FingerprintBasis(**{f.name: getattr(pipe.basis, f.name) if f.name == "sd_moved"
                                        else jnp.asarray(getattr(pipe.basis, f.name).numpy())
                                        for f in dataclasses.fields(embed.FingerprintBasis)})
    return dict(pipe=pipe, imgs=imgs, a0=a0.astype(np.float32), jgen=to_j(pipe.gen_params),
                jlpips=to_j(pipe.lpips_params), jbasis=jbasis, jnoise=[jnp.asarray(n.numpy()) for n in pipe.noise])


def test_synthesis_in_bf16_matches_jax(problem):
    """The 32px generator (channel_max 64) from one bf16 w+ with the fixed
    noise: a bf16 image within 0.05 of max."""
    jw, tw = _pair(np.random.default_rng(5).standard_normal((2, jsg2.n_latent(32), 64)).astype(np.float32))
    want = _jsynthesis(problem["jgen"], jw, problem["jnoise"])
    got = sg2.synthesis(problem["pipe"].gen_params, tw, problem["pipe"].noise)
    assert want.dtype == jnp.bfloat16 and got.dtype == BF
    assert _rel(got, want) < 0.05


def test_encoder_render_goes_through_a_bf16_wplus_as_in_jax(problem):
    """``encoder.render`` against the JAX encoder's render (w+ rounded to bf16,
    synthesis, float32, clip) on the same draws: within 0.03 of the max of the
    image before the clip, the scale bf16 rounds it at (the random generator
    leaves [-1, 1]; the clip moves no two values farther apart)."""
    pipe, rng = problem["pipe"], np.random.default_rng(3)
    alpha = (rng.standard_normal((2, pipe.basis.sigma_rest.shape[0])) * pipe.basis.sigma_rest.numpy()).astype(np.float32)
    bits = rng.integers(0, 2, (2, FKW["key_len"])).astype(np.float32)
    _, wx = jembed.embed(problem["jbasis"], jnp.asarray(alpha), jnp.asarray(bits))
    wplus = jnp.repeat(wx[:, None, :], jsg2.n_latent(32), axis=1).astype(jnp.bfloat16)
    unclipped = _jsynthesis(problem["jgen"], wplus, problem["jnoise"]).astype(jnp.float32)
    want = np.asarray(jnp.clip(unclipped, -1.0, 1.0))
    got, _, _ = enc.render(pipe.gen_params, pipe.basis, pipe.noise, pipe.mcfg, 2,
                           alpha=torch.from_numpy(alpha), bits=torch.from_numpy(bits))
    assert got.dtype == torch.float32 and float(got.abs().max()) <= 1.0
    assert np.abs(got.numpy() - want).max() < 0.03 * float(np.abs(unclipped).max())


@pytest.mark.parametrize("loss", ["perceptual", "mse"])
def test_one_bf16_solve_step_matches_jax(problem, loss):
    """One bf16 step of the JAX solver and the port's from the same state: the
    per-element (pre-update) loss within 0.02 relative; the gradients with
    respect to alpha and key within 0.05 of max of JAX's bf16 ones (read back
    from Adam's first moment, mu' = (1 - b1) g at the first step) and of the
    port's float32 step's (which equals JAX's to ~1e-6,
    ``tests/test_torch_attribute.py``), yet more than 1e-3 of max from the
    latter (the bf16 rounding shows); the port's updated state is float32."""
    pipe, t = problem["pipe"], torch.from_numpy
    jimgs = jnp.asarray(problem["imgs"].numpy())
    acfg_j = JAttributionConfig(steps=1, n_starts=3, loss=loss)
    opt = jattr._make_optimizer(acfg_j)
    if loss == "perceptual":
        jfeats = tuple(f[:, None] for f in jax.jit(jlp.extract_features)(problem["jlpips"],
                                                                          jimgs.astype(jnp.bfloat16)))
        jtgt = None
    else:
        jfeats, jtgt = None, jimgs[:, None]
    jstep = jax.jit(jattr.make_attribution_step(
        problem["jgen"], problem["jlpips"], problem["jbasis"], problem["jnoise"], JModelConfig(**MKW), acfg_j,
        jfeats, jtgt, opt, dtype=jnp.bfloat16))
    params = {"alpha": jnp.asarray(problem["a0"]), "key": jnp.zeros((2, 3, FKW["key_len"]))}
    (_, opt_state), jper = jstep((params, opt.init(params)), 0.0)
    jmu = opt_state[0].mu

    acfg = AttributionConfig(steps=1, n_starts=3, loss=loss)

    def solver(dtype):
        feats, tgt = attr._targets_for_loss(pipe.lpips_params, problem["imgs"], acfg, dtype)
        assert feats is None or all(f.dtype == attr.compute_dtype(dtype) for f in feats)
        return attr.make_attribution_step(pipe.gen_params, pipe.lpips_params, pipe.basis, pipe.noise, pipe.mcfg,
                                          acfg, feats, tgt, dtype=dtype)

    def grads(per_elem):
        alpha, key = t(problem["a0"]).requires_grad_(True), torch.zeros((2, 3, FKW["key_len"]), requires_grad=True)
        per = per_elem(alpha, key)
        return (per.detach(), *torch.autograd.grad(per.sum(), [alpha, key]))

    step, per_elem = solver("bfloat16")
    per, g_alpha, g_key = grads(per_elem)
    _, g32_alpha, g32_key = grads(solver("float32")[1])
    assert per.dtype == g_alpha.dtype == g_key.dtype == torch.float32
    jper = np.array(jper)
    assert float((per - t(jper)).abs().max()) / float(np.abs(jper).min()) < 0.02
    for g, g32, name in ((g_alpha, g32_alpha, "alpha"), (g_key, g32_key, "key")):
        jg = np.asarray(jmu[name]) / 0.1
        assert _rel(g, jg) < 0.05, name
        assert 1e-3 < _rel(g, g32) < 0.05, name
    state, _ = step(attr.init_state(t(problem["a0"]), torch.zeros((2, 3, FKW["key_len"]))))
    assert all(state[k].dtype == torch.float32 for k in ("alpha", "key", "m_alpha", "v_alpha", "m_key", "v_key"))
