"""The port's key registry (``fingerprint/keys.py``), ``cli.keys`` and
``eval/identification.py`` against the JAX package on the CPU.

The registry is numpy in both packages: issuance with one seed gives the
same keys bit for bit, decoding and the capacity math give equal results,
and a registry saved by either package loads in the other.
"""

import json

import numpy as np
import pytest
import torch

from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.eval import study as jstudy
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.fingerprint import keys as jkeys
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.cli import keys as cli_keys
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.config import (
    FingerprintConfig,
    ModelConfig,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.eval import identification as ident_mod
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.eval import study
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.eval.identification import (
    identification_point,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.fingerprint import keys
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.fingerprint import (
    pipeline as pl,
)


@pytest.mark.parametrize("issuance", ["rejection", "rm"])
def test_issuance_and_decoding_match_jax(issuance):
    if issuance == "rm":
        ours, theirs = keys.KeyRegistry.issue_rm(300, 32, seed=4), jkeys.KeyRegistry.issue_rm(300, 32, seed=4)
        assert ours.min_distance == 8
    else:
        ours, theirs = keys.KeyRegistry.issue(200, 24, min_distance=6, seed=4), \
            jkeys.KeyRegistry.issue(200, 24, min_distance=6, seed=4)
    np.testing.assert_array_equal(ours.keys, theirs.keys)
    assert ours.names == theirs.names and ours.min_distance == theirs.min_distance
    rng = np.random.default_rng(1)
    k = ours.keys.shape[1]
    for _ in range(5):
        logits = rng.standard_normal(k) * 3.0
        assert ours.match_soft(logits) == theirs.match_soft(logits)
        bits = (logits > 0).astype(np.int8)
        assert ours.match_hard(bits) == theirs.match_hard(bits)
    for p in (0.0, 0.03, 0.2, 1.0):
        assert keys.identification_error_union_bound(p, len(ours), k, ours.min_distance) == \
            jkeys.identification_error_union_bound(p, len(ours), k, ours.min_distance)
    assert keys.simulate_identification(ours, 0.1, n_trials=50, seed=2) == \
        jkeys.simulate_identification(theirs, 0.1, n_trials=50, seed=2)
    assert study.wilson_ci(3, 7) == jstudy.wilson_ci(3, 7) and study.wilson_ci(0, 0) == (0.0, 1.0)


def test_registries_load_across_packages_and_validate(tmp_path):
    a, b = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    keys.KeyRegistry.issue(20, 16, min_distance=4, seed=2).save(a)
    jreg = jkeys.KeyRegistry.load(a)
    jreg.save(b)
    reg = keys.KeyRegistry.load(b)
    np.testing.assert_array_equal(reg.keys, jreg.keys)
    assert reg.names == jreg.names and reg.min_distance == 4 and len(reg) == 20
    with pytest.raises(ValueError, match="0/1"):
        keys.KeyRegistry(keys=np.full((2, 4), 2), names=["a", "b"], min_distance=1)
    with pytest.raises(RuntimeError, match="ball packing"):
        keys.KeyRegistry.issue(50, 4, min_distance=4, max_tries_per_key=20)
    with pytest.raises(ValueError, match="power of 2"):
        keys.KeyRegistry.issue_rm(4, 24)


def test_cli_keys_issue_and_capacity(tmp_path, capsys):
    out = str(tmp_path / "reg.json")
    assert cli_keys.main(["issue", "--users", "30", "--key_len", "16", "--min_distance", "4", "--seed", "3",
                          "--out", out]) == 0
    line = json.loads(capsys.readouterr().out)
    assert line == {"users": 30, "key_len": 16, "min_distance": 4, "issuance": "rejection", "out": out}
    jreg = jkeys.KeyRegistry.load(out)
    np.testing.assert_array_equal(jreg.keys, jkeys.KeyRegistry.issue(30, 16, 4, seed=3).keys)
    assert cli_keys.main(["issue", "--users", "30", "--key_len", "64", "--issuance", "rm", "--out", out]) == 0
    assert json.loads(capsys.readouterr().out)["min_distance"] == 16 == jkeys.KeyRegistry.load(out).min_distance
    assert cli_keys.main(["capacity", "--users", "30", "--key_len", "16", "--min_distance", "4",
                          "--p_bit", "0.05", "--trials", "40"]) == 0
    cap = json.loads(capsys.readouterr().out)
    assert cap == jkeys.simulate_identification(jkeys.KeyRegistry.issue(30, 16, 4), 0.05, n_trials=40)


MCFG = ModelConfig(img_size=32, channel_max=64, n_mlp=3, style_dim=64)


@pytest.fixture(scope="module")
def pipe():
    return pl.build_pipeline(MCFG, FingerprintConfig(key_len=8, shift=56, n_pca_samples=2000),
                             generator=torch.Generator().manual_seed(0), device="cpu", want_lpips=False)


def test_identification_point_record_and_validation(pipe, monkeypatch):
    rec = identification_point(pipe, key_len=8, sigma=1.0, shift=56, min_distance=3, registry_sizes=(4, 8),
                               samples=4, steps=8, n_starts=2, seed=11, clip_targets=False, dtype="float32")
    assert rec["key_len"] == 8 and rec["min_distance"] == 3 and rec["distinct_users"] == 4
    assert rec["issuance"] == "rejection" and rec["attack"] == "None" and "init" not in rec
    assert 0.0 <= rec["measured_p_bit"] <= 1.0 and rec["mean_bit_acc"] == 1.0 - rec["measured_p_bit"]
    assert [r["registry_size"] for r in rec["by_registry_size"]] == [4, 8]
    for row in rec["by_registry_size"]:
        assert 0.0 <= row["hard_accuracy"] <= 1.0
        assert row["soft_ci95"][0] <= row["soft_accuracy"] <= row["soft_ci95"][1]
        assert 0.0 <= row["union_bound_error"] <= 1.0
    with pytest.raises(ValueError, match=">= 2"):
        identification_point(pipe, registry_sizes=(1,), key_len=8, shift=56, samples=2, steps=2, n_starts=2)
    with pytest.raises(ValueError, match="issuance"):
        identification_point(pipe, registry_sizes=(4,), key_len=8, shift=56, samples=2, steps=2, n_starts=2,
                             issuance="bogus")
    # bfloat16, the reference study's default and the port's, solves in bf16
    solve, dtypes = ident_mod.attr.attribute_chunked, []
    monkeypatch.setattr(ident_mod.attr, "attribute_chunked",
                        lambda *a, **k: dtypes.append(k["dtype"]) or solve(*a, **k))
    bf = identification_point(pipe, registry_sizes=(4,), key_len=8, shift=56, min_distance=3, samples=2, steps=2,
                              n_starts=2, clip_targets=False)
    monkeypatch.undo()
    assert dtypes == ["bfloat16"] and 0.0 <= bf["measured_p_bit"] <= 1.0
    with pytest.raises(ValueError, match="dtype"):
        identification_point(pipe, registry_sizes=(4,), key_len=8, shift=56, min_distance=3, samples=2, steps=2,
                             n_starts=2, dtype="float16")


def test_identification_point_rm_attacked_encoder_init(pipe):
    """Reed-Muller issuance at key_len 32 (the code's distance 8 replaces the
    argument), Blur-attacked targets solved attack-aware, restarts from an
    encoder trained on that channel, in sample chunks of two."""
    rec = identification_point(pipe, key_len=32, sigma=1.0, shift=32, registry_sizes=(4, 64), samples=4,
                               steps=4, n_starts=2, seed=3, clip_targets=False, issuance="rm", attack="Blur",
                               attack_aware=True, init="encoder", encoder_steps=1, chunk_samples=2, dtype="float32")
    assert rec["issuance"] == "rm" and rec["min_distance"] == 8
    assert rec["attack"] == "Blur" and rec["attack_aware"] is True
    assert [r["registry_size"] for r in rec["by_registry_size"]] == [4, 64]
    assert rec["init"] == "encoder" and rec["encoder_steps"] == 1
    assert 0.0 <= rec["encoder_bit_acc"] <= 1.0 and np.isfinite(rec["encoder_final_train_loss"])
