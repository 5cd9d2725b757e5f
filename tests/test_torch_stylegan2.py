"""The port's StyleGAN2 generator vs the JAX package on the CPU.

A 32px, channel_max=64 generator with the JAX package's random weights,
carried over by ``params_from_jax`` and, separately, through the rosinality
state-dict round trip.  Same latents, same noise maps.  Tolerance 1e-4
relative to the output's scale for pixels and for d(mse)/dw: float32 convs
summed in another order, through 7 layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.checkpoints import (
    rosinality as jros,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.config import (
    ModelConfig as JModelConfig,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.models import (
    stylegan2 as jsg2,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.checkpoints import (
    rosinality,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.config import (
    ModelConfig,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.models import (
    stylegan2 as sg2,
)

KW = dict(img_size=32, channel_max=64, n_mlp=2, style_dim=64)
JCFG, CFG = JModelConfig(**KW), ModelConfig(**KW)
RTOL = 1e-4


def _close(got, want):
    np.testing.assert_allclose(got, want, atol=RTOL * max(1.0, float(np.abs(want).max())))


@pytest.fixture(scope="module")
def jparams():
    p = jax.jit(jsg2.init_generator_params, static_argnums=1)(jax.random.PRNGKey(3), JCFG)
    # non-zero noise weights / biases so every term of the layer is exercised
    rng = np.random.default_rng(0)
    p = jax.tree.map(lambda v: v, p)
    for layer in (p["conv1"],) + tuple(p["convs"]):
        layer["noise_weight"] = jnp.asarray(rng.standard_normal(()).astype(np.float32) * 0.3)
        layer["act_bias"] = jnp.asarray(rng.standard_normal(layer["act_bias"].shape).astype(np.float32) * 0.1)
    return p


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(1)
    w = rng.standard_normal((2, 64)).astype(np.float32)
    noise = [rng.standard_normal(s).astype(np.float32) for s in jsg2.noise_shapes(32)]
    target = rng.standard_normal((2, 32, 32, 3)).astype(np.float32) * 0.5
    return w, noise, target


def _jax_forward_grad(jparams, w, noise, target):
    def loss(wv):
        img, _ = jsg2.generate(jparams, [wv], JCFG, input_is_latent=True,
                               noise=[jnp.asarray(n) for n in noise])
        return jnp.mean(jnp.square(img - target)), img

    (_, img), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(jnp.asarray(w))
    return np.asarray(img), np.asarray(g)


def _torch_forward_grad(params, w, noise, target):
    wt = torch.from_numpy(w).requires_grad_(True)
    img = sg2.generate(params, [wt], CFG, input_is_latent=True,
                       noise=[torch.from_numpy(n) for n in noise])
    torch.mean((img - torch.from_numpy(target)) ** 2).backward()
    return img.detach().numpy(), wt.grad.numpy()


def test_generator_pixels_and_latent_grad_match_jax(jparams, inputs):
    w, noise, target = inputs
    jimg, jg = _jax_forward_grad(jparams, w, noise, target)
    timg, tg = _torch_forward_grad(rosinality.params_from_jax(jparams, "cpu", cfg=CFG), w, noise, target)
    assert timg.shape == (2, 32, 32, 3)
    _close(timg, jimg)
    _close(tg, jg)


def test_rosinality_round_trip_matches_jax(jparams, inputs):
    """JAX tree -> rosinality names (JAX exporter) -> port loader gives the
    same tree as params_from_jax and the same pixels: the upsample weights
    are flipped back exactly once, at use."""
    w, noise, target = inputs
    sd = jros.generator_state_dict_from_params(jax.tree.map(np.asarray, jparams))
    params = rosinality.generator_params_from_state_dict(sd, CFG, "cpu")
    jimg, _ = _jax_forward_grad(jparams, w, noise, target)
    timg, _ = _torch_forward_grad(params, w, noise, target)
    _close(timg, jimg)
    direct = rosinality.params_from_jax(jparams, "cpu")
    for (pa, a), (pb, b) in zip(_leaves(params), _leaves(direct)):
        assert pa == pb
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=pa)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], f"{path}.{k}")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _leaves(v, f"{path}[{i}]")]
    return [(path, tree)]


def test_mapping_network_matches_jax(jparams):
    z = np.random.default_rng(2).standard_normal((5, 64)).astype(np.float32)
    want = np.asarray(jsg2.mapping_network(jparams, jnp.asarray(z), JCFG.lr_mlp))
    got = sg2.mapping_network(rosinality.params_from_jax(jparams, "cpu"), torch.from_numpy(z), CFG.lr_mlp)
    _close(got.numpy(), want)


def test_wrong_architecture_is_refused(jparams):
    with pytest.raises(ValueError):
        rosinality.params_from_jax(jparams, "cpu", cfg=ModelConfig(img_size=64, channel_max=64, n_mlp=2, style_dim=64))


def test_init_generator_params_shapes():
    p = sg2.init_generator_params(CFG, torch.Generator().manual_seed(0), "cpu")
    rosinality.validate_generator(p, CFG)
    assert len(p["noises"]) == sg2.num_noise_layers(32)
