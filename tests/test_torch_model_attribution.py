"""The port's model-level attribution vs the JAX package on the CPU: restart
coherence and the threshold (numpy on both sides, exactly), ``attribute_model``
over a StyleGAN2 registry and over a mixed {StyleGAN2, BigGAN} registry from
the JAX package's own starts, the study's statistics on the same solves, the
CLI's target loader; then the port alone: one converging solve that names each
image's model and rejects a held-out model's, the CLI's two modes, and the
calibration solve of a BigGAN registry with its family and attack arguments.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.cli import model_attribute as jcli_ma
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.config import (
    AttributionConfig as JAttributionConfig,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.config import (
    FingerprintConfig as JFingerprintConfig,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.config import (
    ModelConfig as JModelConfig,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.eval import (
    model_attribution_study as jstudy,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.fingerprint import (
    embed as jembed,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.fingerprint import (
    model_attribution as jma,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.fingerprint import (
    pipeline as jpl,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.models import biggan as jbg
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.utils.lhs import (
    lhs_alpha_init_batch,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.cli import (
    model_attribute as cli_ma,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.config import (
    AttackConfig,
    AttributionConfig,
    Config,
    FingerprintConfig,
    ModelConfig,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.eval import (
    model_attribution_study as study,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.fingerprint import (
    model_attribution as ma,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.fingerprint import (
    pipeline as pl,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.models import biggan as bg

from test_torch_biggan import CONFIGS, make_params


def test_restart_coherence_matches_jax_exactly():
    rng = np.random.default_rng(0)
    for s, n, k in ((3, 4, 8), (2, 5, 16), (4, 8, 3)):
        logits = rng.standard_normal((s, n, k)).astype(np.float32)
        losses = rng.random((s, n)).astype(np.float32)
        for top in (0.5, 1.0, 0.25):
            got = ma.restart_coherence(logits, losses, top_frac=top)
            np.testing.assert_array_equal(got, jma.restart_coherence(logits, losses, top_frac=top))
    # the JAX package's worked example: the top half agrees, a split vote halves a bit
    logits = np.array([[[2.0, -1.0], [3.0, 2.0], [-9.0, 9.0], [-9.0, 9.0]]])
    losses = np.array([[0.1, 0.2, 5.0, 5.0]])
    assert ma.restart_coherence(logits, losses) == pytest.approx(0.5)
    assert ma.restart_coherence(logits, losses, top_frac=1.0) == pytest.approx(0.25)
    # fewer than 2 voters: no information
    assert np.isnan(ma.restart_coherence(logits[:, :1], losses[:, :1])).all()
    assert np.isnan(ma.restart_coherence(logits[:, :2], losses[:, :2], top_frac=0.5)).all()


def test_calibrate_open_set_threshold_matches_jax():
    losses = np.random.default_rng(1).random(37) * 1e-3
    for pct, slack in ((99.0, 2.0), (50.0, 1.0), (90.0, 3.0)):
        assert ma.calibrate_open_set_threshold(losses, pct, slack) == jma.calibrate_open_set_threshold(
            losses, pct, slack)
    with pytest.raises(ValueError, match="at least one"):
        ma.calibrate_open_set_threshold(np.array([]))


# ---------------------------------------------------------------------------
# attribute_model against the JAX package: 16px, key on the last 4 of 16 axes
# ---------------------------------------------------------------------------

SG2_KW = dict(img_size=16, style_dim=16, n_mlp=1, channel_max=16)
BG_KW = dict(model="biggan", img_size=16, biggan_label="3")
FKW = dict(key_len=4, shift=12, sigma=1.0, n_pca_samples=500)


def _jax_pipeline(tp, jmcfg, jparams, **biggan):
    """The JAX package's Pipeline holding the port pipeline's weights (in the
    JAX layout), basis and noise: what the solve reads of it."""
    jfp = JFingerprintConfig(**FKW)
    basis = jembed.FingerprintBasis(**{f.name: (jnp.asarray(getattr(tp.basis, f.name).numpy()) if f.name != "sd_moved"
                                                else tp.basis.sd_moved)
                                       for f in dataclasses.fields(jembed.FingerprintBasis)})
    return jpl.Pipeline(mcfg=jmcfg, fpcfg=jfp, gen_params=jparams, basis=basis, pca=None,
                        noise=tuple(jnp.asarray(n.numpy()) for n in tp.noise), **biggan)


@pytest.fixture(scope="module")
def registries():
    """Two StyleGAN2 pipelines and a BigGAN one of the port (their builds are
    held against the JAX package's in test_torch_pipeline.py and
    test_torch_biggan.py), the JAX package's pipelines on the same weights,
    basis and noise, and one fingerprinted target of each model."""
    jpipes, tpipes, targets = {}, {}, {}
    for name, seed in (("sg2_a", 5), ("sg2_b", 6)):
        tp = pl.build_pipeline(ModelConfig(**SG2_KW), FingerprintConfig(**FKW), device="cpu", want_lpips=False,
                               generator=torch.Generator().manual_seed(seed))
        jpipes[name] = _jax_pipeline(tp, JModelConfig(**SG2_KW),
                                     jax.tree.map(lambda t: jnp.asarray(t.numpy()), tp.gen_params))
        tpipes[name] = tp
    bcfg = CONFIGS["no_attention"]
    p, jparams = make_params(bg.BigGANConfig(**bcfg), seed=7)
    tp = pl.build_pipeline(ModelConfig(**BG_KW), FingerprintConfig(**FKW), device="cpu", want_lpips=False,
                           gen_params=p, biggan_cfg=bg.BigGANConfig(**bcfg))
    jpipes["biggan"] = _jax_pipeline(tp, JModelConfig(**BG_KW), jparams, biggan_cfg=jbg.BigGANConfig(**bcfg),
                                     class_onehot=jnp.asarray(tp.class_onehot.numpy()), truncation=0.4)
    tpipes["biggan"] = tp
    for i, name in enumerate(tpipes):
        targets[name] = pl.generate_fingerprinted(tpipes[name], 1, torch.Generator().manual_seed(20 + i))[0].numpy()
    return jpipes, tpipes, targets


@pytest.mark.parametrize("names", [("sg2_a", "sg2_b"), ("sg2_a", "biggan")], ids=["sg2", "mixed"])
def test_attribute_model_matches_jax(registries, names):
    """Both packages solve one target of each model under each model, 2 steps
    from the JAX package's own restarts (model i from fold_in(rng, i)): best
    losses to 1e-4 relative, the same decisions, and every restart's key
    logits (post-update) to 1e-5, but the BigGAN model's to 5e-4.

    Why BigGAN's: optax raises b2 = 0.999 to the step count in float32, where
    the port's bias correction is exact, so after one step the two states
    differ by ~1e-6 (the update's 2e-5 relative times the rate).  One restart
    of this BigGAN solve sits where that moves its next key gradient by 0.5%
    (a ReLU switching; gradients from one state agree to 5e-7 of their
    scale), and its logit ends 1.1e-4 away."""
    jpipes, tpipes, targets = registries
    tgt = np.concatenate([targets[n] for n in names])
    rng = jax.random.PRNGKey(11)
    jres = jma.attribute_model({n: jpipes[n] for n in names}, jnp.asarray(tgt), rng,
                               JAttributionConfig(steps=2, n_starts=3, loss="mse"))
    starts = {n: torch.from_numpy(np.array(lhs_alpha_init_batch(jax.random.fold_in(rng, i), 2, 3,
                                                                jpipes[n].basis.sigma_rest)))
              for i, n in enumerate(names)}
    res = ma.attribute_model({n: tpipes[n] for n in names}, torch.from_numpy(tgt), None,
                             AttributionConfig(steps=2, n_starts=3, loss="mse"), alpha_inits=starts)
    assert res.model_names == list(names)
    np.testing.assert_allclose(res.losses, np.asarray(jres.losses), rtol=1e-4)
    np.testing.assert_array_equal(res.best_model, np.asarray(jres.best_model))
    np.testing.assert_allclose(res.margin, np.asarray(jres.margin), rtol=2e-4)
    np.testing.assert_array_equal(res.key_bits, np.asarray(jres.key_bits))
    for n in names:
        np.testing.assert_allclose(res.results[n].key_logits_all.numpy(), np.asarray(jres.results[n].key_logits_all),
                                   atol=5e-4 if n == "biggan" else 1e-5, err_msg=n)
    np.testing.assert_allclose(res.coherence, np.asarray(jres.coherence))


def test_registry_is_checked_before_any_solve(registries):
    _, tpipes, _ = registries
    acfg = AttributionConfig(steps=1, n_starts=2, loss="mse")
    with pytest.raises(ValueError, match="empty"):
        ma.attribute_model({}, torch.zeros(1, 16, 16, 3), None, acfg)
    k8 = dataclasses.replace(tpipes["sg2_b"], fpcfg=FingerprintConfig(**dict(FKW, key_len=8, shift=8)))
    with pytest.raises(ValueError, match="key_len"):
        ma.attribute_model({"a": tpipes["sg2_a"], "k8": k8}, torch.zeros(1, 16, 16, 3), None, acfg)
    with pytest.raises(ValueError, match="img_size"):
        ma.attribute_model({"a": tpipes["sg2_a"]}, torch.zeros(1, 32, 32, 3), None, acfg)


def test_model_attribution_point_statistics_match_jax(registries, monkeypatch):
    """The port's study over a 2-model registry and a held-out model (2 samples
    each, 2 steps, 4 restarts, chunks of 2), its solves in bfloat16 (the
    default, as in the reference); the JAX package's study then reads the same
    targets and solves (its target draw and solve replaced by the port's, in
    the same order): the two records, decisions included, are equal."""
    _, tpipes, _ = registries
    seen_targets, seen_solves = [], []
    draw, solve = study._fingerprinted_targets, study.attribute_model

    def rec_draw(*a, **k):
        seen_targets.append(draw(*a, **k))
        return seen_targets[-1]

    def rec_solve(*a, **k):
        assert k["dtype"] == "bfloat16"
        seen_solves.append(solve(*a, **k))
        return seen_solves[-1]

    monkeypatch.setattr(study, "_fingerprinted_targets", rec_draw)
    monkeypatch.setattr(study, "attribute_model", rec_solve)
    registry = {"a": tpipes["sg2_a"], "b": tpipes["sg2_b"]}
    held = {"c": pl.build_pipeline(ModelConfig(**SG2_KW), FingerprintConfig(**FKW), device="cpu", want_lpips=False,
                                   generator=torch.Generator().manual_seed(9))}
    kw = dict(key_len=4, sigma=1.0, samples_per_model=2, steps=2, n_starts=4, chunk_samples=2,
              clip_targets=False)
    got = study.model_attribution_point(registry, held, **kw)
    assert len(seen_targets) == 3 and len(seen_solves) == 3

    replay_t, replay_s = iter(seen_targets), iter(seen_solves)
    monkeypatch.setattr(jstudy, "_with_basis", lambda p, k, s: p)
    monkeypatch.setattr(jstudy, "_fingerprinted_targets", lambda *a, **k: next(replay_t))
    monkeypatch.setattr(jstudy, "attribute_model", lambda *a, **k: next(replay_s))
    want = jstudy.model_attribution_point(registry, held, **kw)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert got["coherence_open_set_auc"] is not None and got["n_eval_in_dist"] == 2


def test_cli_target_loader_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    paths = []
    for i, shape in enumerate(((16, 16, 3), (24, 20, 3))):
        p = str(tmp_path / f"t{i}.png")
        Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8)).save(p)
        paths.append(p)
    np.save(tmp_path / "f.npy", rng.standard_normal((16, 16, 3)).astype(np.float32))
    np.save(tmp_path / "u.npy", rng.integers(0, 256, (16, 16, 3), dtype=np.uint8))
    paths += [str(tmp_path / "f.npy"), str(tmp_path / "u.npy")]
    np.testing.assert_array_equal(cli_ma.load_targets(paths, 16), jcli_ma._load_targets(paths, 16))
    with pytest.raises(SystemExit, match="expected"):
        cli_ma.load_targets([str(tmp_path / "f.npy")], 32)


# ---------------------------------------------------------------------------
# the port alone
# ---------------------------------------------------------------------------

TINY = ModelConfig(img_size=32, channel_max=64, n_mlp=3, style_dim=64)
TINY_FP = FingerprintConfig(key_len=8, shift=56, sigma=3.0, n_pca_samples=2000)


@pytest.fixture(scope="module")
def converged():
    """Two registered generators and a held-out one (the tiny converging
    configuration); one target of each, solved under the registry (60 steps, 4
    restarts)."""
    pipes = {n: pl.build_pipeline(TINY, TINY_FP, generator=torch.Generator().manual_seed(s), device="cpu",
                                  want_lpips=False) for n, s in (("a", 0), ("b", 100), ("held", 777))}
    targets = torch.cat([pl.generate_fingerprinted(pipes[n], 1, torch.Generator().manual_seed(i + 1))[0]
                         for i, n in enumerate(pipes)])
    res = ma.attribute_model({n: pipes[n] for n in ("a", "b")}, targets, torch.Generator().manual_seed(3),
                             AttributionConfig(steps=60, n_starts=4, lr=0.2, loss="mse"))
    return pipes, res


def test_converged_solve_names_each_model_and_rejects_the_held_out_one(converged):
    _, res = converged
    idx = np.arange(3)
    np.testing.assert_array_equal(res.best_model[:2], [0, 1])
    assert res.decided.all()  # closed set by default
    own = res.losses[res.best_model, idx]
    other = res.losses[1 - res.best_model, idx]
    assert (own[:2] * 3 < other[:2]).all() and (res.margin[:2] > 3).all(), res.losses
    tau = ma.calibrate_open_set_threshold(own[:2])
    assert own[2] > tau, (own, tau)
    opened = dataclasses.replace(res, decided=own <= tau)
    assert [opened.chosen(s) for s in idx] == ["a", "b", None]
    assert res.coherence.shape == (2, 3) and np.isfinite(res.coherence).all()
    assert (res.coherence >= 0).all() and (res.coherence <= 1).all()


MA_FLAGS = ["--device", "cpu", "--random_init", "--img_size", "16", "--style_dim", "16", "--n_mlp", "1",
            "--channel_max", "16", "--key_len", "4", "--shift", "12", "--loss", "mse", "--n", "2", "--steps", "2"]


def test_cli_model_attribute_self_test_and_images(tmp_path, capsys, monkeypatch):
    out = tmp_path / "ma.json"
    solve, remats = cli_ma.attr.attribute, []

    def spy(*args, **kwargs):
        remats.append(kwargs.get("remat"))
        return solve(*args, **kwargs)

    monkeypatch.setattr(cli_ma.attr, "attribute", spy)
    rec = cli_ma.run(MA_FLAGS + ["--sample_size", "2", "--calibrate", "1", "--no_clip_targets", "--remat",
                                 "--out", str(out)])
    assert remats == [True] * 4  # --remat reaches the calibration's and the registry's solves, two models each
    assert json.loads(out.read_text()) == rec
    assert rec["models"] == ["random_a", "random_b"] and np.asarray(rec["loss_matrix"]).shape == (2, 2)
    assert rec["open_set_threshold"] is not None and 0.0 <= rec["self_test_accuracy"] <= 1.0
    assert [r["target"] for r in rec["decisions"]] == ["random_a#0", "random_b#0"]
    assert all(set(r) == {"target", "model", "best_loss", "margin", "decided"} for r in rec["decisions"])
    assert "self-test accuracy" in capsys.readouterr().out
    # images from disk: an image of model random_a, as .npy and as PNG
    pipe = pl.build_pipeline(ModelConfig(**SG2_KW), FingerprintConfig(key_len=4, shift=12), device="cpu",
                             want_lpips=False, generator=cli_ma.fold_in(0, 0))
    img = pl.generate_fingerprinted(pipe, 1, torch.Generator().manual_seed(9))[0][0].clamp(-1, 1).numpy()
    np.save(tmp_path / "t.npy", img)
    Image.fromarray(np.round((img + 1.0) * 127.5).astype(np.uint8)).save(tmp_path / "t.png")
    paths = [str(tmp_path / "t.npy"), str(tmp_path / "t.png")]
    rec = cli_ma.run(MA_FLAGS + ["--images"] + paths + ["--open_set_threshold", "1e-9"])
    assert [r["target"] for r in rec["decisions"]] == paths and np.asarray(rec["loss_matrix"]).shape == (2, 2)
    assert rec["open_set_threshold"] == 1e-9 and not any(r["decided"] for r in rec["decisions"])
    assert "self_test_accuracy" not in rec
    for bad in (["--models", "nopath"], ["--models", "a=/does/not/exist.npz"]):
        with pytest.raises(SystemExit):
            cli_ma.run(MA_FLAGS + bad)
    with pytest.raises(SystemExit, match="random_init"):
        cli_ma.run([f for f in MA_FLAGS if f != "--random_init"])


def test_calibration_solves_biggan_with_its_family_and_attack_arguments(monkeypatch):
    """--model biggan --calibrate: every calibration solve gets its pipeline's
    class, truncation and architecture, and an attack-aware run the configured
    attack strengths (not the defaults)."""
    cfg_kw = CONFIGS["no_attention"]
    pipes = {n: pl.build_pipeline(ModelConfig(**BG_KW), FingerprintConfig(**FKW), device="cpu", want_lpips=False,
                                  generator=torch.Generator().manual_seed(s), biggan_cfg=bg.BigGANConfig(**cfg_kw))
             for n, s in (("x", 1), ("y", 2))}
    attack = AttackConfig(augmentation="Blur", blur_sigma=1.5)
    cfg = Config(model=ModelConfig(**BG_KW), fingerprint=FingerprintConfig(**FKW), attack=attack,
                 attribution=AttributionConfig(steps=2, n_starts=2, loss="mse", solver_attack="Blur"))
    calls = []
    solve = cli_ma.attr.attribute

    def spy(*a, **k):
        calls.append(k)
        return solve(*a, **k)

    monkeypatch.setattr(cli_ma.attr, "attribute", spy)
    tau = cli_ma.calibrate(pipes, cfg, 1, torch.Generator().manual_seed(0), clip=True)
    assert np.isfinite(tau) and tau > 0
    assert len(calls) == 2
    for k, p in zip(calls, pipes.values()):
        assert k["biggan_cfg"] is p.biggan_cfg and k["class_onehot"] is p.class_onehot
        assert k["truncation"] == 0.4 and k["attack_cfg"] == attack and k["mcfg"].model == "biggan"
