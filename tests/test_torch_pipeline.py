"""The port's PCA, basis, embedding and fingerprinted generation vs the JAX
package on the CPU.

PCA: eigenvalues to 1e-4 relative, and principal subspaces through their
projectors (eigenvector signs and near-degenerate tail rotations may differ
between LAPACK builds, projectors do not).  Embedding and generation are
fed the JAX basis, draws and noise; latents to 1e-5, images to 1e-4
relative (float32 generator).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.config import (
    FingerprintConfig as JFingerprintConfig,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.config import (
    ModelConfig as JModelConfig,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.fingerprint import embed as jembed
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.fingerprint import pca as jpca
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.fingerprint import (
    pipeline as jpl,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.models import (
    stylegan2 as jsg2,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.checkpoints import (
    rosinality,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.config import (
    FingerprintConfig,
    ModelConfig,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.fingerprint import (
    embed,
    pca,
    pipeline,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.utils import lhs

MKW = dict(img_size=32, channel_max=64, n_mlp=3, style_dim=64)
FKW = dict(key_len=8, shift=56, sigma=1.0, sd_moved=1.0, n_pca_samples=2000)


def _projector(rows):
    return rows.T @ rows


def basis_from_jax(jb) -> embed.FingerprintBasis:
    return embed.FingerprintBasis(**{
        f.name: (torch.from_numpy(np.asarray(getattr(jb, f.name))) if f.name != "sd_moved"
                 else jb.sd_moved)
        for f in dataclasses.fields(embed.FingerprintBasis)
    })


@pytest.fixture(scope="module")
def jpipe():
    mcfg = JModelConfig(**MKW)
    gen = jax.jit(jsg2.init_generator_params, static_argnums=1)(jax.random.PRNGKey(5), mcfg)
    return jpl.build_pipeline(jax.random.PRNGKey(0), mcfg, JFingerprintConfig(**FKW),
                              gen_params=gen, want_lpips=False)


def test_pca_from_samples_matches_jax():
    rng = np.random.default_rng(0)
    q, _ = np.linalg.qr(rng.standard_normal((12, 12)))
    x = (rng.standard_normal((3000, 12)) * np.linspace(3.0, 0.2, 12)) @ q.T + 0.5
    x = x.astype(np.float32)
    jb = jpca.pca_from_samples(jnp.asarray(x))
    tb = pca.pca_from_samples(torch.from_numpy(x))
    np.testing.assert_allclose(tb.sigma.numpy(), np.asarray(jb.sigma), rtol=1e-4)
    np.testing.assert_allclose(tb.mean.numpy(), np.asarray(jb.mean), atol=1e-5)
    # well-separated spectrum: the sign rule makes the rows themselves agree
    np.testing.assert_allclose(tb.pc.numpy(), np.asarray(jb.pc), atol=1e-4)


def test_generator_pca_spans_the_jax_subspaces(jpipe):
    """Same generator, same z: same eigenvalues and the same content and key
    subspaces (compared as projectors)."""
    z = np.array(jax.random.normal(jax.random.PRNGKey(1), (2000, 64)))
    jb = jpca.pca_from_samples(jsg2.mapping_network(jpipe.gen_params, jnp.asarray(z), 0.01))
    tparams = rosinality.params_from_jax(jpipe.gen_params, "cpu")
    tb = pca.perform_pca_for_params(tparams, 0.01, z=torch.from_numpy(z))
    jsig, tsig = np.asarray(jb.sigma), tb.sigma.numpy()
    np.testing.assert_allclose(tsig ** 2, jsig ** 2, rtol=1e-4, atol=1e-4 * jsig[0] ** 2)
    jf = jembed.build_basis(jb, JFingerprintConfig(**FKW))
    tf = embed.build_basis(tb, FingerprintConfig(**FKW))
    for name in ("u_cap", "v_cap"):
        np.testing.assert_allclose(_projector(getattr(tf, name).numpy()),
                                   _projector(np.asarray(getattr(jf, name))), atol=1e-3)
    top = slice(0, 8)  # the well-separated head: rows agree, sign rule included
    np.testing.assert_allclose(tb.pc.numpy()[top], np.asarray(jb.pc)[top], atol=1e-3)


def test_build_basis_and_embed_match_jax(jpipe):
    jb = jpipe.pca
    tb = pca.PCABasis(*(torch.from_numpy(np.array(a)) for a in (jb.pc, jb.sigma, jb.mean)))
    jf = jembed.build_basis(jb, JFingerprintConfig(**FKW))
    tf = embed.build_basis(tb, FingerprintConfig(**FKW))
    for f in dataclasses.fields(embed.FingerprintBasis):
        if f.name == "sd_moved":
            assert tf.sd_moved == jf.sd_moved
        else:
            np.testing.assert_allclose(getattr(tf, f.name).numpy(), np.asarray(getattr(jf, f.name)),
                                       atol=1e-6, err_msg=f.name)
    rng = np.random.default_rng(2)
    alpha = rng.standard_normal((3, 56)).astype(np.float32)
    bits = rng.integers(0, 2, (3, 8)).astype(np.float32)
    jw0, jwx = jembed.embed(jf, jnp.asarray(alpha), jnp.asarray(bits))
    tw0, twx = embed.embed(tf, torch.from_numpy(alpha), torch.from_numpy(bits))
    np.testing.assert_allclose(tw0.numpy(), np.asarray(jw0), atol=1e-5)
    np.testing.assert_allclose(twx.numpy(), np.asarray(jwx), atol=1e-5)
    over = alpha * 4.0
    np.testing.assert_allclose(embed.alpha_bound_penalty(tf, torch.from_numpy(over)).numpy(),
                               np.asarray(jembed.alpha_bound_penalty(jf, jnp.asarray(over))),
                               rtol=1e-5)


def test_generate_fingerprinted_given_jax_draws(jpipe):
    imgs, w0, wx, bits, alpha = jpl.generate_fingerprinted(jpipe, jax.random.PRNGKey(3), 2)
    tpipe = pipeline.Pipeline(
        mcfg=ModelConfig(**MKW), fpcfg=FingerprintConfig(**FKW),
        gen_params=rosinality.params_from_jax(jpipe.gen_params, "cpu"),
        basis=basis_from_jax(jpipe.basis), pca=None,
        noise=[torch.from_numpy(np.asarray(n)) for n in jpipe.noise], device=torch.device("cpu"),
    )
    timgs, tw0, twx, tbits, _ = pipeline.generate_fingerprinted(
        tpipe, 2, alpha=np.asarray(alpha), bits=np.asarray(bits))
    np.testing.assert_allclose(twx.numpy(), np.asarray(wx), atol=1e-5)
    want = np.asarray(imgs)
    np.testing.assert_allclose(timgs.numpy(), want, atol=1e-4 * max(1.0, np.abs(want).max()))


def test_build_pipeline_draws_are_seeded():
    mcfg, fpcfg = ModelConfig(**MKW), FingerprintConfig(**{**FKW, "n_pca_samples": 500})
    a = pipeline.build_pipeline(mcfg, fpcfg, generator=torch.Generator().manual_seed(4), want_lpips=False,
                                device="cpu")
    b = pipeline.build_pipeline(mcfg, fpcfg, generator=torch.Generator().manual_seed(4), want_lpips=False,
                                device="cpu")
    ia = pipeline.generate_fingerprinted(a, 2, torch.Generator().manual_seed(5))[0]
    ib = pipeline.generate_fingerprinted(b, 2, torch.Generator().manual_seed(5))[0]
    torch.testing.assert_close(ia, ib, rtol=0, atol=0)
    assert ia.shape == (2, 32, 32, 3) and torch.isfinite(ia).all()


def test_lhs_is_centered_latin_hypercube():
    s = lhs.latin_hypercube_batch(2, 5, 7, torch.Generator().manual_seed(0)).numpy()
    assert s.shape == (2, 5, 7)
    for b in range(2):
        for d in range(7):
            np.testing.assert_allclose(np.sort(s[b, :, d]), (np.arange(5) + 0.5) / 5, atol=1e-7)
    sigma = torch.linspace(0.5, 2.0, 7)
    a = lhs.lhs_alpha_init_batch(2, 5, sigma, torch.Generator().manual_seed(0))
    assert (a.abs() <= sigma).all()
