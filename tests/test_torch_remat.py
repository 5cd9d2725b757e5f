"""Gradient checkpointing (``remat`` / ``remat_lpips``) in the port on the CPU.

A checkpointed synthesis block keeps its inputs and runs its forward again in
the backward, so the forward is the same arithmetic and the gradients are the
plain ones: against the port without ``remat`` the images are bitwise equal
and the gradients within 1e-6 of their scale, and against the JAX package's
``synthesis(..., remat=True)`` on the same numpy inputs and weights the image
is within 1e-5 and the gradients within 1e-4 of their scale (float32 convs
summed in another order).  A solve step with ``remat`` and ``remat_lpips``
gives the plain step's losses, and a backward pass keeps fewer bytes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.models import (
    stylegan2 as jsg2,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.checkpoints import (
    rosinality,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.config import (
    AttributionConfig,
    FingerprintConfig,
    ModelConfig,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.fingerprint import (
    attribute as attr,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.fingerprint import (
    pipeline as pl,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.models import (
    stylegan2 as sg2,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.utils.lhs import (
    lhs_alpha_init_batch,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.utils.tree import (
    tree_leaves,
    tree_map,
)

KW = dict(img_size=32, style_dim=64, channel_max=64, n_mlp=2)
CFG = ModelConfig(**KW)


@pytest.fixture(scope="module")
def jparams():
    """A random generator as a tree of numpy arrays (both packages take it), with
    non-zero noise weights and biases."""
    p = tree_map(lambda t: t.numpy(), sg2.init_generator_params(CFG, torch.Generator().manual_seed(4), "cpu"))
    rng = np.random.default_rng(0)
    for layer in (p["conv1"],) + tuple(p["convs"]):
        layer["noise_weight"] = rng.standard_normal(()).astype(np.float32) * 0.3
        layer["act_bias"] = rng.standard_normal(layer["act_bias"].shape).astype(np.float32) * 0.1
    return p


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(1)
    latent = rng.standard_normal((2, CFG.n_latent, 64)).astype(np.float32)
    noise = [rng.standard_normal(s).astype(np.float32) for s in jsg2.noise_shapes(32)]
    cot = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    return latent, noise, cot


def _port_grads(params, latent, noise, cot, remat):
    """Image and the gradients of <image, cot> in the latent and every parameter,
    and the bytes the backward keeps: what autograd's saved-tensor hooks pack
    outside the checkpointed blocks plus the tensors the blocks keep as inputs."""
    params = rosinality.params_from_jax(params, "cpu", cfg=CFG)
    leaves = [t.requires_grad_(True) for t in tree_leaves(_synthesis_part(params))]
    lat = torch.from_numpy(latent).requires_grad_(True)
    kept = {}

    def pack(t):
        kept[(t.data_ptr(), tuple(t.shape))] = t.numel() * t.element_size()
        return t

    checkpoint = torch.utils.checkpoint.checkpoint

    def held_inputs(fn, *args, **kwargs):
        for t in args:
            if torch.is_tensor(t):
                kept[(t.data_ptr(), tuple(t.shape))] = t.numel() * t.element_size()
        return checkpoint(fn, *args, **kwargs)

    torch.utils.checkpoint.checkpoint = held_inputs
    try:
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            img = sg2.synthesis(params, lat, [torch.from_numpy(n) for n in noise], remat=remat)
    finally:
        torch.utils.checkpoint.checkpoint = checkpoint
    grads = torch.autograd.grad((img * torch.from_numpy(cot)).sum(), [lat] + leaves)
    return img.detach(), [g.numpy() for g in grads], sum(kept.values())


def _synthesis_part(params):
    """The parameters synthesis reads (not the mapping network, nor the stored noise)."""
    return {k: v for k, v in params.items() if k not in ("style", "noises")}


def _close(got, want, rel):
    scale = max(1e-30, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= rel * scale


def test_remat_synthesis_is_the_plain_forward_with_the_plain_gradients(jparams, inputs):
    img0, g0, kept0 = _port_grads(jparams, *inputs, remat=False)
    img1, g1, kept1 = _port_grads(jparams, *inputs, remat=True)
    assert torch.equal(img0, img1)
    assert len(g0) == len(g1) > 2
    for a, b in zip(g0, g1):
        _close(b, a, 1e-6)
    print(f"backward keeps {kept0} bytes without remat, {kept1} with: {kept0 / kept1:.2f}x less")
    assert kept1 < kept0


def test_remat_synthesis_matches_jax_remat(jparams, inputs):
    """oneDNN's CPU convs pick their algorithm by the host's instruction set and
    land ~1e-4 of the gradients' scale from JAX on some hosts (AMD EPYC):
    parity is checked with PyTorch's direct convs, as the other parity tests do."""
    latent, noise, cot = inputs
    with torch.backends.mkldnn.flags(enabled=False):
        img, grads, _ = _port_grads(jparams, latent, noise, cot, remat=True)

    def f(p, lat):
        img = jsg2.synthesis(p, lat, [jnp.asarray(n) for n in noise], remat=True)
        return jnp.sum(img * cot), img

    (_, jimg), (jg_p, jg_lat) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
        jax.tree.map(jnp.asarray, jparams), jnp.asarray(latent))
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), atol=1e-5)
    jleaves = [np.asarray(jg_lat)] + [np.asarray(t) for t in tree_leaves(
        _synthesis_part(rosinality.params_from_jax(jax.tree.map(np.asarray, jg_p), "cpu")))]
    assert len(jleaves) == len(grads)
    for got, want in zip(grads, jleaves):
        assert got.shape == want.shape
        _close(got, want, 1e-4)


def test_attribution_step_with_remat_gives_the_plain_losses():
    """Two perceptual solve steps (4 chains, LPIPS-VGG16 on 32px images) from
    one state, with ``remat`` and ``remat_lpips`` and without: equal losses."""
    pipe = pl.build_pipeline(CFG, FingerprintConfig(key_len=8, shift=48, n_pca_samples=500),
                             generator=torch.Generator().manual_seed(0), device="cpu")
    targets = pl.generate_fingerprinted(pipe, 2, torch.Generator().manual_seed(1))[0].clamp(-1, 1)
    acfg = AttributionConfig(steps=2, n_starts=2, loss="perceptual")
    feats, _ = attr._targets_for_loss(pipe.lpips_params, targets, acfg)
    alpha0 = lhs_alpha_init_batch(2, 2, pipe.basis.sigma_rest, torch.Generator().manual_seed(2))
    losses = {}
    for remat in (False, True):
        step, _ = attr.make_attribution_step(pipe.gen_params, pipe.lpips_params, pipe.basis, pipe.noise, CFG, acfg,
                                             feats, None, remat=remat, remat_lpips=remat)
        state = attr.init_state(torch.as_tensor(alpha0), torch.zeros((2, 2, 8)))
        losses[remat] = []
        for _ in range(2):
            state, per = step(state)
            losses[remat].append(per)
    for a, b in zip(losses[False], losses[True]):
        assert torch.equal(a, b)
    assert not torch.equal(losses[False][0], losses[False][1])  # the step moved the chains
