"""The port's encoder (``fingerprint/encoder.py``) and ``cli.attribute --init
encoder`` against the JAX package on the CPU.

Same numpy inputs on both sides; the JAX encoder's weights carried over by
``encoder_params_from_jax``.  Tolerances: forward rtol 1e-4 / atol 1e-5 and
loss + gradients rtol 1e-4 (float32 convs summed in another order), five
clipped Adam steps rtol 1e-5 (elementwise arithmetic on top of those
gradients), the render at the generator parity tolerance of
``tests/test_torch_stylegan2.py`` (1e-4 of the output's scale).
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.fingerprint import (
    embed as jembed,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.fingerprint import (
    encoder as jenc,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.models import (
    stylegan2 as jsg2,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.checkpoints import (
    rosinality,
    state,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.cli import (
    attribute as cli_attribute,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.config import (
    FingerprintConfig,
    ModelConfig,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.fingerprint import (
    encoder as enc,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.fingerprint import (
    pipeline as pl,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.fingerprint.embed import (
    FingerprintBasis,
    embed,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.models import (
    stylegan2 as sg2,
)

D_ALPHA, KEY_LEN = 24, 8
ECFG = enc.EncoderConfig(width=8, max_width=16, head_dim=16)


@pytest.fixture(scope="module")
def jinit():
    """The JAX package's ``init_encoder`` at 32px (one compile).  At width 8 /
    max_width 16 the 16px encoder is the same tree without the last stride-2
    stage (both stages after the first map 16 -> 16 channels)."""
    j = jax.jit(jenc.init_encoder, static_argnums=(1, 2, 3, 4))(
        jax.random.PRNGKey(0), 32, D_ALPHA, KEY_LEN, jenc.EncoderConfig(width=8, max_width=16, head_dim=16))
    return jax.tree.map(np.asarray, j)


def _jparams(jinit, img_size):
    return dict(jinit, convs=jinit["convs"][:{16: 2, 32: 3}[img_size]])


def _batch(rng, b, size):
    imgs = np.clip(rng.standard_normal((b, size, size, 3)) * 0.6, -1, 1).astype(np.float32)
    sigma = (0.5 + rng.random(D_ALPHA)).astype(np.float32)
    alpha = (rng.standard_normal((b, D_ALPHA)) * sigma).astype(np.float32)
    bits = rng.integers(0, 2, (b, KEY_LEN)).astype(np.float32)
    return imgs, alpha, bits, sigma


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _jloss(p, imgs, alpha, bits, sigma):
    a_hat, k_logits = jenc.apply_encoder(p, imgs)
    l_alpha = jnp.mean(jnp.square(a_hat - alpha / sigma))
    return l_alpha + jnp.mean(optax.sigmoid_binary_cross_entropy(k_logits, bits))


def _to_port_layout(jtree):
    """A JAX-layout tree (params or gradients) in the port's layout, as numpy."""
    return jax.tree.map(lambda t: t.numpy(), enc.encoder_params_from_jax(jtree, "cpu"))


def _assert_trees_close(got, want, rtol, atol=0.0):
    got_l, want_l = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        w = np.asarray(w)
        np.testing.assert_allclose(np.asarray(g), w, rtol=rtol, atol=atol * max(1.0, float(np.abs(w).max())))


@pytest.mark.parametrize("img_size", [16, 32])
def test_apply_encoder_matches_jax(jinit, img_size):
    jp = _jparams(jinit, img_size)
    imgs, *_ = _batch(np.random.default_rng(img_size), 3, img_size)
    ja, jk = jax.jit(jenc.apply_encoder)(jp, imgs)
    ta, tk = enc.apply_encoder(enc.encoder_params_from_jax(jp, "cpu"), torch.from_numpy(imgs))
    assert ta.shape == (3, D_ALPHA) and tk.shape == (3, KEY_LEN)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-4, atol=1e-5)
    # the port's own init has the reference's layout (shapes, zero biases, 0.1-scaled heads)
    own = enc.init_encoder(img_size, D_ALPHA, KEY_LEN, ECFG, torch.Generator().manual_seed(0), "cpu")
    assert jax.tree.map(np.shape, jax.tree.map(lambda t: t.numpy(), own)) == \
        jax.tree.map(np.shape, _to_port_layout(jp))
    assert float(own["trunk_b"].abs().max()) == 0.0
    assert float(own["head_key"].std()) < 0.2 * float(own["trunk"].std())


@pytest.mark.parametrize("img_size", [16, 32])
def test_loss_and_gradients_match_jax(jinit, img_size):
    jp = _jparams(jinit, img_size)
    imgs, alpha, bits, sigma = _batch(np.random.default_rng(7 + img_size), 4, img_size)
    jl, jg = jax.jit(jax.value_and_grad(_jloss))(jp, imgs, alpha, bits, sigma)
    leaves, spec = torch.utils._pytree.tree_flatten(enc.encoder_params_from_jax(jp, "cpu"))
    leaves = [t.requires_grad_(True) for t in leaves]
    tl = enc.encoder_loss(torch.utils._pytree.tree_unflatten(leaves, spec), *_t(imgs, alpha, bits, sigma))
    tg = torch.utils._pytree.tree_unflatten([g.numpy() for g in torch.autograd.grad(tl, leaves)], spec)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-4)
    _assert_trees_close(tg, _to_port_layout(jg), rtol=1e-4, atol=1e-4)


def test_five_clipped_adam_steps_match_optax(jinit):
    """Five updates on fixed batches; the third batch's targets are scaled up
    so that its gradient's global norm exceeds the clip of 1 and the clip
    fires (both regimes are asserted on the JAX side).  The update arithmetic
    alone (``clip_adam_update`` fed the JAX gradients) holds rtol 1e-5; whole
    ``train_step``s, whose own gradients differ by float32 summation order,
    hold the gradient tolerance rtol 1e-4."""
    jp = _jparams(jinit, 16)
    rng = np.random.default_rng(3)
    batches = []
    for i in range(5):
        imgs, alpha, bits, sigma = _batch(rng, 4, 16)
        batches.append((imgs, alpha * (40.0 if i == 2 else 0.05), bits, sigma))
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(2e-3))

    @jax.jit
    def jstep(p, st, b):
        loss, g = jax.value_and_grad(_jloss)(p, *b)
        upd, st = tx.update(g, st, p)
        return optax.apply_updates(p, upd), st, loss, g, optax.global_norm(g)

    st = tx.init(jp)
    norms, jlosses, jgrads, jps = [], [], [], jp
    for b in batches:
        jps, st, loss, g, norm = jstep(jps, st, b)
        jlosses.append(float(loss))
        jgrads.append(g)
        norms.append(float(norm))
    assert norms[2] > 1.0 and min(norms[:2] + norms[3:]) < 1.0, norms
    want = _to_port_layout(jps)

    leaves, spec = torch.utils._pytree.tree_flatten(enc.encoder_params_from_jax(jp, "cpu"))
    ost = enc.init_opt_state(enc.encoder_params_from_jax(jp, "cpu"))
    for g in jgrads:
        g_leaves, _ = torch.utils._pytree.tree_flatten(enc.encoder_params_from_jax(g, "cpu"))
        leaves, ost = enc.clip_adam_update(leaves, g_leaves, ost, 2e-3, 1.0)
    assert ost["count"] == 5
    got = torch.utils._pytree.tree_unflatten([t.numpy() for t in leaves], spec)
    _assert_trees_close(got, want, rtol=1e-5, atol=1e-7)

    ecfg = enc.EncoderConfig(width=8, max_width=16, head_dim=16, lr=2e-3, grad_clip=1.0)
    tp, ost = enc.encoder_params_from_jax(jp, "cpu"), enc.init_opt_state(enc.encoder_params_from_jax(jp, "cpu"))
    losses = []
    for b in batches:
        tp, ost, loss = enc.train_step(tp, ost, *_t(*b), ecfg)
        losses.append(float(loss))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    _assert_trees_close(jax.tree.map(lambda t: t.numpy(), tp), want, rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def render_problem():
    """A 16px generator (random weights, drawn by the port: both packages share
    the tree), a random basis and given alpha / bits."""
    kw = dict(img_size=16, channel_max=32, n_mlp=2, style_dim=32)
    gen = sg2.init_generator_params(ModelConfig(**kw), torch.Generator().manual_seed(5), "cpu")
    jparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()), gen)
    rng = np.random.default_rng(4)
    d = 32
    arrs = dict(u_cap=rng.standard_normal((D_ALPHA, d)).astype(np.float32) * 0.2,
                v_cap=rng.standard_normal((KEY_LEN, d)).astype(np.float32) * 0.2,
                sigma_rest=(0.5 + rng.random(D_ALPHA)).astype(np.float32),
                sigma_key=np.ones(KEY_LEN, np.float32), mean=rng.standard_normal(d).astype(np.float32) * 0.1,
                max_alpha=np.full(D_ALPHA, 3.0, np.float32), min_alpha=np.full(D_ALPHA, -3.0, np.float32))
    noise = [rng.standard_normal(s).astype(np.float32) for s in jsg2.noise_shapes(16)]
    alpha = (rng.standard_normal((3, D_ALPHA)) * arrs["sigma_rest"]).astype(np.float32)
    bits = rng.integers(0, 2, (3, KEY_LEN)).astype(np.float32)
    return kw, jparams, arrs, noise, alpha, bits


def test_render_matches_jax_synthesis_in_float32(render_problem):
    """The render's draws through the port's embed and synthesis in float32
    against JAX's float32 synthesis of the same w+, clipped (1e-4 of max).
    The render itself goes through a bf16 w+, as the JAX encoder's does: a
    float32 image in [-1, 1] within 0.03 of the float32 image's max before the
    clip, and apart from it by more than 1e-4 of max (the bf16 render against
    JAX's own: ``tests/test_torch_bf16.py``)."""
    kw, jparams, arrs, noise, alpha, bits = render_problem
    jbasis = jembed.FingerprintBasis(**{k: jnp.asarray(v) for k, v in arrs.items()}, sd_moved=1.0)
    _, wx = jembed.embed(jbasis, jnp.asarray(alpha), jnp.asarray(bits))
    wplus = jnp.repeat(wx[:, None, :], jsg2.n_latent(16), axis=1)
    unclipped = np.asarray(jax.jit(jsg2.synthesis)(jparams, wplus, [jnp.asarray(n) for n in noise]))
    want = np.clip(unclipped, -1, 1)
    scale = float(np.abs(unclipped).max())
    basis = FingerprintBasis(**{k: torch.from_numpy(v) for k, v in arrs.items()}, sd_moved=1.0)
    params, tnoise = rosinality.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu"), [torch.from_numpy(n) for n in noise]
    _, twx = embed(basis, torch.from_numpy(alpha), torch.from_numpy(bits))
    got32 = torch.clamp(sg2.synthesis(params, twx[:, None, :].expand(-1, jsg2.n_latent(16), -1), tnoise), -1.0, 1.0)
    np.testing.assert_allclose(got32.numpy(), want, atol=1e-4 * max(1.0, scale))
    got, a, b = enc.render(params, basis, tnoise, ModelConfig(**kw), 3, alpha=torch.from_numpy(alpha),
                           bits=torch.from_numpy(bits))
    assert torch.equal(a, torch.from_numpy(alpha)) and torch.equal(b, torch.from_numpy(bits))
    assert got.dtype == torch.float32 and float(got.abs().max()) <= 1.0
    assert 1e-4 * scale < np.abs(got.numpy() - want).max() < 0.03 * scale


def test_encoder_solve_init_semantics(jinit):
    rng = np.random.default_rng(9)
    params = enc.encoder_params_from_jax(_jparams(jinit, 16), "cpu")
    # large head weights so some logits leave +-2 and the clip has work to do
    params["head_key"] = params["head_key"] * 200.0
    sigma = torch.from_numpy((0.5 + rng.random(D_ALPHA)).astype(np.float32))
    basis = FingerprintBasis(u_cap=torch.zeros(D_ALPHA, 32), v_cap=torch.zeros(KEY_LEN, 32), sigma_rest=sigma,
                             sigma_key=torch.ones(KEY_LEN), mean=torch.zeros(32), max_alpha=3 * sigma,
                             min_alpha=-3 * sigma)
    targets = torch.from_numpy(_batch(rng, 3, 16)[0])
    a0, k0 = enc.encoder_solve_init(params, basis, targets, 5, torch.Generator().manual_seed(0), jitter=0.25)
    a_white, logits = enc.apply_encoder(params, targets)
    assert a0.shape == (3, 5, D_ALPHA) and k0.shape == (3, 5, KEY_LEN)
    assert torch.equal(a0[:, 0], a_white * sigma)  # restart 0 is the prediction itself
    cloud = a0[:, 1:] - a0[:, :1]
    assert float(cloud.abs().max()) > 0 and bool((cloud.abs() <= 0.25 * sigma + 1e-6).all())
    assert float(logits.abs().max()) > 2.0 and float(k0.abs().max()) <= 2.0
    assert torch.equal(k0[:, 0], torch.clamp(logits, -2, 2)) and torch.equal(k0[:, 4], k0[:, 0])


TINY_M = ModelConfig(img_size=32, style_dim=64, n_mlp=3, channel_max=64)


def test_train_encoder_loss_falls_in_twenty_steps():
    pipe = pl.build_pipeline(TINY_M, FingerprintConfig(key_len=8, shift=56, n_pca_samples=500),
                             generator=torch.Generator().manual_seed(0), device="cpu", want_lpips=False)
    ecfg = enc.EncoderConfig(width=16, max_width=32, head_dim=32, steps=20, batch=8)
    params, curve = enc.train_encoder(pipe.gen_params, pipe.basis, pipe.noise, mcfg=TINY_M, ecfg=ecfg,
                                      generator=torch.Generator().manual_seed(3))
    assert curve.shape == (20,) and bool(torch.isfinite(curve).all())
    assert float(curve[-5:].mean()) < float(curve[:5].mean())
    assert enc.auto_batch(64) == 64 and enc.auto_batch(128) == 64 and enc.auto_batch(256) == 16
    assert enc.auto_batch(1024) == 4 == jenc.auto_batch(1024)
    with pytest.raises(NotImplementedError, match="biggan"):
        enc.train_encoder(pipe.gen_params, pipe.basis, pipe.noise, mcfg=ModelConfig(model="biggan"), ecfg=ecfg)


CLI = ["--device", "cpu", "--random_init", "--img_size", "32", "--style_dim", "32", "--n_mlp", "2",
       "--channel_max", "32", "--key_len", "8", "--shift", "16", "--loss", "mse", "--n", "4", "--steps", "6",
       "--seed", "5", "--init", "encoder", "--encoder_steps", "6", "--encoder_batch", "4"]


def test_cli_attribute_encoder_init_cut_and_resumed_equals_whole(tmp_path, capsys):
    """Two samples in chunks of one, Blur-attacked and attack-aware, restarts from
    the encoder; the cut run is the whole run's directory set back to the end
    of its first chunk, resumed with other --init flags that the saved scheme
    overrides."""
    flags = ["--sample_size", "2", "--chunk_samples", "1", "--augmentation", "Blur", "--attack_aware"]
    whole = cli_attribute.run(CLI + flags + ["--save_dir", str(tmp_path / "whole")])
    out = capsys.readouterr().out
    assert "encoder trained in" in out and "zero-step decode bit acc" in out
    assert state.load_init_scheme(whole.run_dir) == {"init": "encoder", "encoder_steps": 6, "encoder_batch": 4,
                                                     "encoder_jitter": 0.25}
    st, arrays = state.load_state(whole.run_dir)
    cut = str(tmp_path / "cut")
    shutil.copytree(whole.run_dir, cut)
    os.remove(os.path.join(cut, "result.txt"))
    st.next_sample, st.bit_accs, st.success = 1, st.bit_accs[:1], int(st.bit_accs[0] >= 1.0)
    state.save_state(cut, st, {k: (v[:1] if v.ndim else v) for k, v in arrays.items()})
    resumed = cli_attribute.run(["--device", "cpu", "--resume", cut, "--init", "lhs", "--encoder_steps", "1",
                                 "--chunk_samples", "1"])
    assert "encoder trained in" in capsys.readouterr().out
    assert open(os.path.join(cut, "result.txt")).read() == open(os.path.join(whole.run_dir, "result.txt")).read()
    assert resumed.losses == whole.losses[1:] and resumed.bit_accs == whole.bit_accs
