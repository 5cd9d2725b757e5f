"""The port's FID stack against the JAX package, on the CPU.

- ``eval/inception.py``: ``preprocess`` at 64 -> 299 (an upscale) and
  512 -> 299 (a downscale, antialiased as ``jax.image.resize``) within 1e-5;
  ``inception_features`` at 75 and 96 px, batch 2, on one parameter tree in
  the JAX layout (built from ``jax.eval_shape`` of JAX's initialiser and
  filled from a numpy seed, with BN statistics that are not the identity, so
  the fold is held), within 1e-4 of the largest feature; the torchvision name
  map and converter; the card as the default device.
- ``eval/fid.py``: ``FeatureStats`` and ``frechet_distance`` on the same
  statistics in both packages at d = 64, full rank and rank-deficient (the
  square root complex, its real part taken), within 1e-6 relative;
  ``disc_pooled_features`` and ``fid_between_disc`` on a tiny
  discriminator.  No 2048-d square root runs here: the FID at its full size
  is held on the card by ``chip_smoke.py``.
"""

import contextlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.eval import fid as jfid
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.eval import inception as jinc
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.eval import fid
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.eval import inception as inc
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.utils.tree import tree_leaves


@pytest.fixture(autouse=True)
def no_onednn():
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _rel(got, want) -> float:
    g = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    w = np.asarray(want)
    return float(np.abs(g - w).max() / np.abs(w).max())


@pytest.fixture(scope="module")
def trees():
    """The JAX-layout Inception tree in numpy, from the shapes of JAX's
    initialiser (not run: it takes tens of seconds on the CPU): He-normal
    convs, gamma in [0.5, 1.5], beta and mean N(0, 0.1^2), var in [0.5, 2]."""
    shapes = jax.eval_shape(jinc.init_inception_params, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)

    def fill(path, s):
        name = path[-1].key
        if name == "w":
            kh, kw, cin, _ = s.shape
            return (rng.standard_normal(s.shape) * np.sqrt(2.0 / (cin * kh * kw))).astype(np.float32)
        lo_hi = {"gamma": (0.5, 1.5), "var": (0.5, 2.0)}.get(name)
        if lo_hi:
            return rng.uniform(*lo_hi, s.shape).astype(np.float32)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(fill, shapes)
    return tree, jax.tree.map(jnp.asarray, tree), inc.params_from_jax(tree, "cpu")


_jfeatures = jax.jit(jinc.inception_features)


@pytest.mark.parametrize("size", [75, 96])
def test_inception_features_match_jax(trees, size):
    _, jtree, params = trees
    x = np.random.default_rng(size).uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    want = np.asarray(_jfeatures(jtree, jnp.asarray(x)))
    got = inc.inception_features(params, torch.from_numpy(x))
    assert got.shape == want.shape == (2, 2048)
    assert _rel(got, want) < 1e-4


@pytest.mark.parametrize("size", [64, 512])
def test_preprocess_matches_jax_resize(size):
    x = np.random.default_rng(size).uniform(-1, 1, (1, size, size, 3)).astype(np.float32)
    want = np.asarray(jinc.preprocess(jnp.asarray(x)))
    got = inc.preprocess(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 299, 299, 3)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_torchvision_names_and_converter_match_jax(trees):
    tree, _, params = trees
    pairs = list(inc.torch_name_pairs())
    assert sorted(pairs) == sorted(jinc.torch_name_pairs(tree)) and len(pairs) == 94
    sd = {}
    for short, leaf, prefix in pairs:
        p = tree[short] if leaf is None else tree[short][leaf]
        sd[f"{prefix}.conv.weight"] = np.transpose(p["w"], (3, 2, 0, 1))
        for ours, theirs in (("gamma", "weight"), ("beta", "bias"), ("mean", "running_mean"),
                             ("var", "running_var")):
            sd[f"{prefix}.bn.{theirs}"] = p[ours]
    got = inc.params_from_torch_state_dict(sd, device="cpu")
    want = jinc.params_from_torch_state_dict(sd, tree)
    assert len(tree_leaves(got)) == len(jax.tree.leaves(want)) == 5 * 94
    for g, w, p in zip(tree_leaves(got), jax.tree.leaves(want), tree_leaves(params)):
        np.testing.assert_array_equal(g.numpy(), w)
        torch.testing.assert_close(g, p, rtol=0, atol=0)


def test_init_is_the_structure_of_jax_and_defaults_to_the_card(trees):
    _, jtree, _ = trees
    params = inc.init_inception_params(torch.Generator().manual_seed(11), "cpu")
    assert [tuple(t.shape) for t in tree_leaves(params)] == [tuple(t.shape) for t in jax.tree.leaves(jtree)]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            inc.init_inception_params(torch.Generator().manual_seed(11))


@contextlib.contextmanager
def _quiet():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # scipy's warnings on a singular product
        yield


def _stats(rng, n, d):
    st = fid.FeatureStats()
    x = rng.standard_normal((n, d)) @ rng.standard_normal((d, d)) * 0.3 + rng.standard_normal(d)
    for i in range(0, n, 7):  # streamed in uneven chunks
        st.update(x[i:i + 7].astype(np.float32))
    return st, x


def test_feature_stats_and_frechet_distance_match_jax():
    rng = np.random.default_rng(3)
    for n in (200, 4):  # full rank; rank 3 of 64 (the square root is complex, its real part taken)
        s1, x1 = _stats(rng, n, 64)
        s2, x2 = _stats(rng, n, 64)
        j1 = jfid.FeatureStats()
        j1.update(x1.astype(np.float32))
        mu, cov = s1.finalize()
        jmu, jcov = j1.finalize()
        np.testing.assert_allclose(mu, jmu, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(cov, jcov, rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(cov, np.cov(x1.astype(np.float32).astype(np.float64), rowvar=False),
                                   rtol=1e-8, atol=1e-8)
        args = (*s1.finalize(), *s2.finalize())
        with _quiet():
            got, want = fid.frechet_distance(*args), jfid.frechet_distance(*args)
        assert got == pytest.approx(want, rel=1e-6)
        assert fid.frechet_distance(*s1.finalize(), *s1.finalize()) == pytest.approx(0.0, abs=1e-3 * abs(want))


def test_disc_pooled_features_and_distance_match_jax():
    from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.config import ModelConfig
    from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.models import stylegan2 as sg2

    d = sg2.init_discriminator_params(ModelConfig(img_size=16, channel_max=16), torch.Generator().manual_seed(0),
                                      "cpu")
    jd = jax.tree.map(lambda t: jnp.asarray(t.numpy()), d)
    rng = np.random.default_rng(4)
    a = rng.uniform(-1, 1, (6, 16, 16, 3)).astype(np.float32)
    b = np.clip(a + 0.3 * rng.standard_normal(a.shape), -1, 1).astype(np.float32)
    got = fid.disc_pooled_features(d, torch.from_numpy(a), batch=4)
    want = np.asarray(jfid.disc_pooled_features(jd, jnp.asarray(a), batch=4))
    assert got.shape == want.shape == (6, 16 * 3)  # from_rgb and the two res blocks (16 -> 8 -> 4)
    assert _rel(got, want) < 1e-5
    with _quiet():
        dist = fid.fid_between_disc(d, torch.from_numpy(a), torch.from_numpy(b), batch=4)
        jdist = jfid.fid_between_disc(jd, jnp.asarray(a), jnp.asarray(b), batch=4)
    assert dist == pytest.approx(jdist, rel=1e-4) and dist > 0
