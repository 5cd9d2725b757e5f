"""The port's capacity sweep (``eval/sweep.py``), ``cli.evaluate`` and the
content-latent cosine of ``evaluate_attribution`` against the JAX package, on
the CPU.

- ``evaluate_attribution(..., basis=, true_w0=)``: ``latent_cos`` and
  ``mean_latent_cos`` on shared arrays equal JAX's within 1e-6.
- ``run_sweep`` on the tiny converging configuration (style_dim 64,
  channel_max 64, n_mlp 3, the key on the last 8 axes: shift 56; 16 px, mse,
  200 steps x 4 restarts, unclipped targets as ``cli.evaluate --random_init``
  solves them): the record has the JAX record's fields, every planted key comes
  back and the content latent with it (cosine > 0.99); a grid point whose band
  leaves the W space is skipped as in JAX; ``solver_attack`` is refused by
  both packages.
- ``cli.evaluate --device cpu`` end to end at that size (2 steps).
"""

import dataclasses
import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.config import (
    AttributionConfig as JAttributionConfig,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.config import ModelConfig as JModelConfig
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.eval import sweep as jsweep
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.fingerprint import attribute as jattr
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.fingerprint import embed as jembed
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.cli import evaluate as cli
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.config import (
    AttributionConfig,
    FingerprintConfig,
    ModelConfig,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.eval import sweep
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.fingerprint import attribute as attr
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.fingerprint import embed
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.fingerprint.pca import PCABasis

TINY = dict(img_size=16, style_dim=64, n_mlp=3, channel_max=64)
TINY_ARGV = ["--device", "cpu", "--random_init", "--img_size", "16", "--style_dim", "64", "--n_mlp", "3",
             "--channel_max", "64", "--key_lens", "8", "--sigmas", "1.0", "--samples", "2", "--loss", "mse"]


@pytest.fixture(autouse=True)
def no_onednn():
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def test_latent_cos_matches_jax():
    rng = np.random.default_rng(0)
    d, k, s = 16, 4, 5
    pc = np.linalg.qr(rng.standard_normal((d, d)))[0].T.astype(np.float32)
    pca = PCABasis(pc=torch.from_numpy(pc), sigma=torch.from_numpy(np.linspace(2, 0.1, d).astype(np.float32)),
                   mean=torch.from_numpy(rng.standard_normal(d).astype(np.float32)))
    basis = embed.build_basis(pca, FingerprintConfig(key_len=k, shift=d - k))
    jbasis = jembed.FingerprintBasis(**{f.name: getattr(basis, f.name) if f.name == "sd_moved"
                                        else jnp.asarray(getattr(basis, f.name).numpy())
                                        for f in dataclasses.fields(embed.FingerprintBasis)})
    alpha = rng.standard_normal((s, d - k)).astype(np.float32)
    alpha[0] = 0.0  # the mean alone
    w0 = rng.standard_normal((s, d)).astype(np.float32)
    w0[1] = 0.0  # a zero latent: the floored denominator
    bits = rng.integers(0, 2, (s, k)).astype(np.float32)
    got_bits = bits.copy()
    got_bits[2, 0] = 1 - got_bits[2, 0]
    res = attr.AttributionResult(alpha=torch.from_numpy(alpha), key_logits=None, key_bits=torch.from_numpy(got_bits),
                                 loss=None, losses_all=None, best_start=None)
    jres = jattr.AttributionResult(alpha=jnp.asarray(alpha), key_logits=None, key_bits=jnp.asarray(got_bits),
                                   loss=None, losses_all=None, best_start=None)
    ev = attr.evaluate_attribution(res, torch.from_numpy(bits), basis=basis, true_w0=torch.from_numpy(w0))
    jev = jattr.evaluate_attribution(jres, jnp.asarray(bits), basis=jbasis, true_w0=jnp.asarray(w0))
    np.testing.assert_allclose(ev["latent_cos"].numpy(), np.asarray(jev["latent_cos"]), rtol=1e-6, atol=1e-6)
    assert float(ev["mean_latent_cos"]) == pytest.approx(float(jev["mean_latent_cos"]), rel=1e-6, abs=1e-6)
    assert float(ev["latent_cos"][1]) == 0.0
    for key in ("mean_bit_acc", "attribution_acc"):
        assert float(ev[key]) == pytest.approx(float(jev[key]))
    assert "latent_cos" not in attr.evaluate_attribution(res, torch.from_numpy(bits))


@pytest.fixture(scope="module")
def converged():
    return sweep.run_sweep(0, ModelConfig(**TINY), key_lens=(8,), sigmas=(1.0,), shifts=(56, 60), samples=2,
                           acfg=AttributionConfig(steps=200, n_starts=4, loss="mse"), clip_targets=False, device="cpu")


def test_sweep_recovers_planted_keys_with_jaxs_fields(converged):
    assert len(converged) == 1  # shift 60 + key_len 8 leaves the 64-d W space: skipped
    p = converged[0]
    assert [f.name for f in dataclasses.fields(sweep.SweepPoint)] == \
        [f.name for f in dataclasses.fields(jsweep.SweepPoint)]
    assert (p.key_len, p.sigma, p.shift) == (8, 1.0, 56)
    assert p.mean_bit_acc == 1.0 and p.attribution_acc == 1.0
    assert p.mean_latent_cos > 0.99
    assert p.watermark_lpips > 0 and p.watermark_mse > 0 and p.fid is None and p.fid_disc is None
    rec = json.loads(sweep.sweep_to_json(converged))[0]
    assert set(rec) == {f.name for f in dataclasses.fields(jsweep.SweepPoint)}


def test_sweep_refuses_a_solver_attack_as_jax_does():
    kw = dict(key_lens=(8,), samples=1)
    with pytest.raises(ValueError, match="CLEAN targets"):
        sweep.run_sweep(0, ModelConfig(**TINY), acfg=AttributionConfig(solver_attack="Jpeg"), device="cpu", **kw)
    with pytest.raises(ValueError, match="CLEAN targets"):
        jsweep.run_sweep(None, JModelConfig(**TINY), acfg=JAttributionConfig(solver_attack="Jpeg"), **kw)


def test_sweep_point_seed_folds_the_reference_hash():
    from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.utils.lhs import fold_in

    assert sweep.sweep_point_seed(3, 8, 56) == fold_in(3, hash((8, 56)) % (1 << 30)).initial_seed()
    assert sweep.sweep_point_seed(3, 8, 56) != sweep.sweep_point_seed(3, 8, 48)


def test_cli_evaluate_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "sweep.json"
    assert cli.main(TINY_ARGV + ["--steps", "2", "--n", "2", "--shifts", "48,56", "--out", str(out)]) == 0
    recs = json.loads(out.read_text())
    assert [(r["key_len"], r["shift"]) for r in recs] == [(8, 48), (8, 56)]
    for r in recs:
        assert set(r) == {f.name for f in dataclasses.fields(jsweep.SweepPoint)}
        assert all(math.isfinite(r[k]) for k in ("mean_bit_acc", "watermark_lpips", "watermark_mse",
                                                  "mean_latent_cos"))
        assert r["fid"] is None
    assert "[evaluate] wrote" in capsys.readouterr().out
