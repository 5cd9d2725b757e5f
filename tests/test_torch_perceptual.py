"""The port's in-environment perceptual backbones against the JAX package's,
on the CPU, every comparison on weights carried across from one side to the
other:

- the discriminator backbone (``losses/disc_percept.py``): its feature maps on
  a tiny discriminator within 1e-5 of max in float32 and 0.03 of max in bf16
  (the weights cast to bf16 before the layers, as in JAX), the LPIPS value
  through it, one bf16 solve step with it (per-element loss 0.02 relative,
  key-logit gradient 0.05 of max, ``tests/test_torch_bf16.py``'s bounds), and
  a file written by JAX's ``flatten_params`` loaded;
- the 2AFC machinery (``losses/lpips_train.py``): the ranking head and its
  loss, the 2AFC and JND scores, per-layer distances, and one step of
  ``train_lin_heads`` from the same heads and batch within 1e-5 (optax takes
  the bias correction's power in float32; the port's is exact);
- calibration (``losses/calibrate.py``): each distortion family on one image,
  the triplets' structure, and ``rank_accuracy`` of a perfect metric.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.checkpoints.flat import (
    flatten_params as jflatten,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.config import (
    AttributionConfig as JAttributionConfig,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.config import ModelConfig as JModelConfig
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.fingerprint import attribute as jattr
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.fingerprint import embed as jembed
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.losses import calibrate as jcal
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.losses import disc_percept as jdp
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.losses import lpips as jlp
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.losses import lpips_train as jlt
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.config import (
    AttributionConfig,
    FingerprintConfig,
    ModelConfig,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.fingerprint import attribute as attr
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.fingerprint import embed
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.fingerprint import pipeline as pl
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.losses import calibrate as cal
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.losses import disc_percept as dp
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.losses import lpips as lp
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.losses import lpips_train as lt
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.models import stylegan2 as sg2
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.utils.lhs import fold_in
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.utils.tree import tree_leaves

BF = torch.bfloat16
_jdisc_features = jax.jit(jdp.disc_features)  # one compile a dtype: cheaper than op by op


def _np(t):
    return t.detach().float().numpy() if torch.is_tensor(t) else np.asarray(t, np.float32)


def _rel(got, want) -> float:
    """max |got - want| / max |want|."""
    g, w = _np(got), _np(want)
    return float(np.abs(g - w).max() / np.abs(w).max())


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_jax(v) for v in tree]
    return jnp.asarray(tree.numpy())


def _disc(img_size: int, channel_max: int, seed: int):
    """A random discriminator (unit-normal convs, biases N(0, 0.1^2)) for the
    port, and the same weights for the JAX package."""
    d = sg2.init_discriminator_params(ModelConfig(img_size=img_size, channel_max=channel_max),
                                      torch.Generator().manual_seed(seed), "cpu")
    g = torch.Generator().manual_seed(seed + 1)
    for layer in [d["from_rgb"]] + [rb[k] for rb in d["blocks"] for k in ("conv1", "conv2", "skip")]:
        for name in ("act_bias", "bias"):
            if name in layer:
                layer[name] = 0.1 * torch.randn(layer[name].shape, generator=g)
    return d, _to_jax(d)


@pytest.fixture(scope="module")
def disc16():
    return _disc(16, 32, 0)


def _images(seed: int, *shape):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)


# ---------------------------------------------------------------------------
# disc_percept
# ---------------------------------------------------------------------------


def test_disc_features_match_jax_in_float32_and_bf16(disc16):
    d, jd = disc16
    x = _images(0, 2, 16, 16, 3)
    want = _jdisc_features(jd, jnp.asarray(x))
    got = dp.disc_features(d, torch.from_numpy(x))
    assert [tuple(f.shape) for f in got] == [f.shape for f in want] == [(2, 16, 16, 32), (2, 8, 8, 32),
                                                                       (2, 4, 4, 32)]
    assert dp.disc_feature_channels(d) == jdp.disc_feature_channels(jd) == (32, 32, 32)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert np.abs(_np(g) - _np(w)).max() <= 1e-5 * max(1.0, float(np.abs(w).max()))
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    want = _jdisc_features(jd, jx)
    got = dp.disc_features(d, torch.from_numpy(np.array(jx.astype(jnp.float32))).to(BF))
    f32 = dp.disc_features(d, torch.from_numpy(np.array(jx.astype(jnp.float32))))
    for g, w, g32 in zip(got, want, f32):
        assert g.dtype == BF and w.dtype == jnp.bfloat16
        assert _rel(g, w) < 0.03
        assert _rel(g, g32) > 1e-4  # the weights and layers did round to bf16


def test_backbone_cast_once_gives_the_same_features(disc16):
    """A solve casts the discriminator's feature layers once (``backbone_in``);
    the features are then those of the per-call cast, bit for bit, and the
    layers the features do not use keep their dtype."""
    d, _ = disc16
    params = dp.build_disc_percept_params(d)
    cast = lp.backbone_in(params, BF)
    assert all(t.dtype == BF for k in ("from_rgb", "blocks") for t in tree_leaves(cast["disc"][k]))
    rest = [k for k in d if k not in ("from_rgb", "blocks")]
    assert rest and all(t.dtype == torch.float32 for k in rest for t in tree_leaves(cast["disc"][k]))
    assert all(t.dtype == torch.float32 for t in tree_leaves(d))  # the caller's tree is not changed
    x = torch.from_numpy(_images(3, 2, 16, 16, 3)).to(BF)
    for g, w in zip(lp.extract_raw_features(cast, x), lp.extract_raw_features(params, x)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    vgg = {"vgg": [], "lin": []}
    assert lp.backbone_in(vgg, BF) is vgg


def test_disc_lpips_value_matches_jax(disc16):
    d, jd = disc16
    a, b = _images(1, 2, 16, 16, 3), _images(2, 2, 16, 16, 3)
    params, jparams = dp.build_disc_percept_params(d), jdp.build_disc_percept_params(jd)
    for g, w in zip(params["lin"], jparams["lin"]):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    want = np.asarray(jax.jit(jlp.lpips)(jparams, jnp.asarray(a), jnp.asarray(b)))
    got = lp.lpips(params, torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(_np(got), want, rtol=1e-5)
    assert float(lp.lpips(params, torch.from_numpy(a), torch.from_numpy(a)).abs().max()) < 1e-6


def test_load_disc_percept_reads_a_jax_export(disc16, tmp_path):
    d, jd = disc16
    path = tmp_path / "g.npz.disc.npz"
    np.savez(path, **jflatten(jax.tree.map(np.asarray, jd)))
    loaded = dp.load_disc_percept(str(path), device="cpu")
    assert set(loaded) == {"disc", "lin"}
    leaves, want = tree_leaves(loaded["disc"]), tree_leaves(d)
    assert len(leaves) == len(want)
    for g, w in zip(leaves, want):
        assert g.device.type == "cpu"
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert [float(w[0]) for w in loaded["lin"]] == pytest.approx([1 / 32] * 3)


def test_one_bf16_solve_step_with_a_disc_backbone_matches_jax():
    """The solver takes the discriminator backbone through the fused head
    unchanged: one bf16 step of both packages from one state, 16 px."""
    mkw = dict(img_size=16, style_dim=16, n_mlp=1, channel_max=16)
    fkw = dict(key_len=4, shift=12, sigma=1.0, n_pca_samples=300)
    pipe = pl.build_pipeline(ModelConfig(**mkw), FingerprintConfig(**fkw), device="cpu", want_lpips=False,
                             generator=torch.Generator().manual_seed(0))
    imgs = pl.generate_fingerprinted(pipe, 2, torch.Generator().manual_seed(1))[0]
    d, jd = _disc(16, 16, 3)
    params, jparams = dp.build_disc_percept_params(d), jdp.build_disc_percept_params(jd)
    a0 = (np.random.default_rng(2).uniform(-1, 1, (2, 3, 12)) * pipe.basis.sigma_rest.numpy()).astype(np.float32)
    acfg = AttributionConfig(steps=1, n_starts=3, loss="perceptual")
    feats, _ = attr._targets_for_loss(params, imgs, acfg, "bfloat16")
    assert all(f.dtype == BF for f in feats)
    _, per_elem = attr.make_attribution_step(pipe.gen_params, params, pipe.basis, pipe.noise, pipe.mcfg, acfg,
                                             feats, None, dtype="bfloat16")
    alpha, key = torch.from_numpy(a0).requires_grad_(True), torch.zeros((2, 3, 4), requires_grad=True)
    per = per_elem(alpha, key)
    (g_key,) = torch.autograd.grad(per.sum(), [key])

    to_j = lambda tree: jax.tree.map(lambda v: jnp.asarray(v.numpy()), tree)  # noqa: E731
    jbasis = jembed.FingerprintBasis(**{f.name: getattr(pipe.basis, f.name) if f.name == "sd_moved"
                                        else jnp.asarray(getattr(pipe.basis, f.name).numpy())
                                        for f in dataclasses.fields(embed.FingerprintBasis)})
    acfg_j = JAttributionConfig(steps=1, n_starts=3, loss="perceptual")
    opt = jattr._make_optimizer(acfg_j)
    jfeats = tuple(f[:, None] for f in jax.jit(jlp.extract_features)(jparams,
                                                                     jnp.asarray(imgs.numpy()).astype(jnp.bfloat16)))
    jstep = jax.jit(jattr.make_attribution_step(to_j(pipe.gen_params), jparams, jbasis,
                                                [jnp.asarray(n.numpy()) for n in pipe.noise], JModelConfig(**mkw),
                                                acfg_j, jfeats, None, opt, dtype=jnp.bfloat16))
    params_j = {"alpha": jnp.asarray(a0), "key": jnp.zeros((2, 3, 4))}
    (_, opt_state), jper = jstep((params_j, opt.init(params_j)), 0.0)
    jper = np.asarray(jper)
    assert float(np.abs(_np(per) - jper).max()) / float(np.abs(jper).min()) < 0.02
    assert _rel(g_key, np.asarray(opt_state[0].mu["key"]) / 0.1) < 0.05


# ---------------------------------------------------------------------------
# lpips_train
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def rank_heads():
    jrank = jlt.init_dist2logit_params(jax.random.PRNGKey(0))
    return jrank, jax.tree.map(lambda v: torch.from_numpy(np.array(v)), jrank)


def test_ranking_head_and_scores_match_jax(rank_heads):
    jrank, rank = rank_heads
    rng = np.random.default_rng(4)
    d0, d1 = rng.uniform(0, 1, 16).astype(np.float32), rng.uniform(0, 1, 16).astype(np.float32)
    judge = np.sign(rng.uniform(-1, 1, 16)).astype(np.float32)
    want = np.asarray(jlt.dist2logit(jrank, jnp.asarray(d0), jnp.asarray(d1)))
    np.testing.assert_allclose(_np(lt.dist2logit(rank, torch.from_numpy(d0), torch.from_numpy(d1))), want,
                               rtol=1e-5, atol=1e-7)
    want = float(jlt.bce_ranking_loss(jrank, jnp.asarray(d0), jnp.asarray(d1), jnp.asarray(judge)))
    got = float(lt.bce_ranking_loss(rank, torch.from_numpy(d0), torch.from_numpy(d1), torch.from_numpy(judge)))
    assert got == pytest.approx(want, rel=1e-5)
    gts = rng.uniform(0, 1, 16)
    d1[:3] = d0[:3]  # ties score 0.5
    assert lt.score_2afc(d0, d1, gts) == jlt.score_2afc(d0, d1, gts)
    sames = (rng.uniform(0, 1, 16) < 0.5).astype(np.float64)
    assert lt.score_jnd(d0, sames) == jlt.score_jnd(d0, sames)
    # the port's own initializer: N(0, 1/cin) weights, zero biases
    fresh = lt.init_dist2logit_params(torch.Generator().manual_seed(0), "cpu")
    assert [tuple(fresh[k]["w"].shape) for k in ("l1", "l2", "l3")] == [(5, 32), (32, 32), (32, 1)]
    assert all(float(fresh[k]["b"].abs().max()) == 0 for k in ("l1", "l2", "l3"))


def test_distance_per_layer_matches_jax():
    rng = np.random.default_rng(5)
    shapes = [(2, 8, 8, 4), (2, 4, 4, 6)]
    f0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    f1 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    lin = [rng.uniform(0, 1, s[-1]).astype(np.float32) for s in shapes]
    want, wper = jlp.distance_from_features({"lin": lin}, [jnp.asarray(f) for f in f0], [jnp.asarray(f) for f in f1],
                                            ret_per_layer=True)
    got, per = lp.distance_from_features({"lin": [torch.from_numpy(w) for w in lin]},
                                         [torch.from_numpy(f) for f in f0], [torch.from_numpy(f) for f in f1],
                                         ret_per_layer=True)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6)
    for g, w in zip(per, wper):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-6)
    torch.testing.assert_close(got, per[0] + per[1])


def test_one_lin_head_step_matches_jax(disc16, rank_heads, monkeypatch):
    """One Adam step of the heads and the ranking net from the same start (JAX's
    ranking net carried across) on the same batch, the discriminator as
    backbone: within 1e-5 of JAX's."""
    d, jd = disc16
    jrank, rank = rank_heads
    rng = np.random.default_rng(6)
    ref = _images(7, 4, 16, 16, 3)
    p0 = np.clip(ref + 0.05 * rng.standard_normal(ref.shape), -1, 1).astype(np.float32)
    p1 = np.clip(ref + 0.5 * rng.standard_normal(ref.shape), -1, 1).astype(np.float32)
    judge = np.array([-1, -1, 1, -1], np.float32)
    jbatch = {k: jnp.asarray(v) for k, v in (("ref", ref), ("p0", p0), ("p1", p1), ("judge", judge))}
    batch = {k: torch.from_numpy(v) for k, v in (("ref", ref), ("p0", p0), ("p1", p1), ("judge", judge))}
    jparams, params = jdp.build_disc_percept_params(jd), dp.build_disc_percept_params(d)
    jfit, jrank1 = jlt.train_lin_heads(jparams, [jbatch], steps=1, lr=1e-2, rng=jax.random.PRNGKey(0))
    monkeypatch.setattr(lt, "init_dist2logit_params", lambda generator, device="cpu": rank)
    fit, rank1 = lt.train_lin_heads(params, [batch], steps=1, lr=1e-2)
    for g, w, w0 in zip(fit["lin"], jfit["lin"], jparams["lin"]):
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=1e-5)
        assert float(np.abs(np.asarray(w) - np.asarray(w0)).max()) > 1e-3  # the step moved the heads
        assert float(g.min()) >= 0.0
    for k in ("l1", "l2", "l3"):
        for n in ("w", "b"):
            np.testing.assert_allclose(_np(rank1[k][n]), np.asarray(jrank1[k][n]), atol=1e-5)
    assert fit["disc"] is params["disc"]  # the backbone is not trained


def test_lin_weights_round_trip_across_packages(tmp_path):
    lin = [np.random.default_rng(k).uniform(0, 1, c).astype(np.float32) for k, c in enumerate((4, 8, 16))]
    jlt.save_lin_weights(str(tmp_path / "j.npz"), tuple(jnp.asarray(w) for w in lin))
    back = lt.load_lin_weights(str(tmp_path / "j.npz"), device="cpu")
    lt.save_lin_weights(str(tmp_path / "p.npz"), back)
    for a, b, c in zip(lin, back, jlt.load_lin_weights(str(tmp_path / "p.npz"))):
        np.testing.assert_array_equal(_np(b), a)
        np.testing.assert_array_equal(np.asarray(c), a)


# ---------------------------------------------------------------------------
# calibrate
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", ["blur", "noise", "jpeg"])
def test_distort_matches_jax(family):
    x = np.clip(_images(8, 2, 16, 16, 3) * 0.9, -1, 1)
    strength = jcal._LEVELS[family][2]
    key = jax.random.PRNGKey(3)
    want = np.asarray(jcal._distort(family, jnp.asarray(x), strength, key))
    noise = torch.from_numpy(np.array(jax.random.normal(key, x.shape)))
    got = cal._distort(family, torch.from_numpy(x), strength, noise=noise)
    assert cal._LEVELS[family] == jcal._LEVELS[family]
    np.testing.assert_allclose(_np(got), want, atol=2e-4 if family == "jpeg" else 1e-5)


def test_triplet_batches_structure():
    batches = list(cal.triplet_batches(torch.Generator().manual_seed(0), batch=2, size=16, n_batches=9,
                                       device="cpu"))
    assert len(batches) == 9
    for i, b in enumerate(batches):
        assert set(b) == {"ref", "p0", "p1", "judge"}
        assert all(b[k].shape == (2, 16, 16, 3) and b[k].dtype == torch.float32 for k in ("ref", "p0", "p1"))
        assert all(float(b[k].abs().max()) <= 1.0 for k in ("ref", "p0", "p1"))
        assert b["judge"].shape == (2,) and len(set(b["judge"].tolist())) == 1 and b["judge"][0] in (-1.0, 1.0)
        assert float((b["p0"] - b["p1"]).abs().max()) > 0
    # batch i depends on fold_in(generator, i) alone
    again = next(cal.triplet_batches(fold_in(torch.Generator().manual_seed(0), 0), batch=2, size=16, n_batches=1,
                                     device="cpu"))
    assert not torch.equal(again["ref"], batches[0]["ref"])
    again = list(cal.triplet_batches(torch.Generator().manual_seed(0), batch=2, size=16, n_batches=2,
                                     device="cpu"))
    torch.testing.assert_close(again[1]["p1"], batches[1]["p1"])


def test_rank_accuracy_of_a_perfect_metric_is_one(monkeypatch):
    """A metric that orders every triplet by its distortion's rung agrees with
    every judge: the swap and the judge's sign are consistent."""
    def rung(family, img, strength, generator=None, noise=None):
        return img * (1.0 - 0.05 * (1 + cal._LEVELS[family].index(strength)))

    monkeypatch.setattr(cal, "_distort", rung)
    monkeypatch.setattr(lp, "lpips", lambda params, a, b: (a - b).abs().mean(dim=(1, 2, 3)))
    params = {"lin": [torch.ones(1)]}
    assert cal.rank_accuracy(params, size=16, batch=2, n_batches=6) == 1.0
    monkeypatch.setattr(lp, "lpips", lambda params, a, b: -(a - b).abs().mean(dim=(1, 2, 3)))
    assert cal.rank_accuracy(params, size=16, batch=2, n_batches=6) == 0.0


def test_calibration_keeps_heads_nonnegative_and_runs_on_the_disc(disc16):
    d, _ = disc16
    params = dp.build_disc_percept_params(d)
    fitted = cal.calibrate_lin_heads(params, generator=torch.Generator().manual_seed(5), size=16, batch=2, steps=3)
    assert fitted["disc"] is d and len(fitted["lin"]) == 3
    assert all(float(w.min()) >= 0.0 for w in fitted["lin"])
    assert any(not torch.equal(a, b) for a, b in zip(fitted["lin"], params["lin"]))
    assert 0.0 <= cal.rank_accuracy(fitted, size=16, batch=2, n_batches=2) <= 1.0
