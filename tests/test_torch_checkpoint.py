"""The port's run state (``checkpoints/state.py``) and ``cli.attribute --resume``.

A run directory written by either package loads in the other (same file
names, same keys, configs that ignore each other's extra fields), and a CLI
run that is cut after a sample chunk and resumed writes the ``result.txt``
of the uninterrupted run.
"""

import json
import os
import shutil

import numpy as np

from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.checkpoints import state as jstate
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.config import Config as JConfig
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.checkpoints import state
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.cli import (
    attribute as cli_attribute,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.config import (
    AttackConfig,
    AttributionConfig,
    Config,
)

TINY = ["--device", "cpu", "--random_init", "--img_size", "32", "--style_dim", "32", "--n_mlp", "2",
        "--channel_max", "32", "--key_len", "8", "--shift", "16", "--loss", "mse", "--n", "4",
        "--steps", "6", "--seed", "3"]


def _arrays(rows):
    rng = np.random.default_rng(rows)
    return {"true_bits": rng.integers(0, 2, (rows, 8)).astype(np.float32),
            "recovered_bits": rng.integers(0, 2, (rows, 8)).astype(np.float32),
            "losses_all": rng.random((rows, 4)).astype(np.float32), "first_sample": np.asarray(0)}


def test_save_load_round_trip(tmp_path):
    assert state.load_state(str(tmp_path)) == (None, {})
    cfg = Config(attribution=AttributionConfig(prune_starts=2, solver_attack="Jpeg"),
                 attack=AttackConfig(augmentation="Jpeg", jpeg_quality=70))
    st = state.AttributionRunState(next_sample=2, bit_accs=[1.0, 0.875], success=1, seed=9, config=cfg.to_dict())
    state.save_state(str(tmp_path), st, _arrays(2))
    assert sorted(os.listdir(tmp_path)) == ["attribution_arrays.npz", "attribution_state.json"]
    got, arrays = state.load_state(str(tmp_path))
    assert (got.next_sample, got.bit_accs, got.success, got.seed) == (2, [1.0, 0.875], 1, 9)
    assert Config.from_dict(got.config) == cfg  # JSON made the tuples lists; from_dict makes them tuples again
    for k, v in _arrays(2).items():
        np.testing.assert_array_equal(arrays[k], v)
    # the state alone (no arrays) leaves the arrays of the last save in place
    st.next_sample = 3
    state.save_state(str(tmp_path), st)
    got, arrays = state.load_state(str(tmp_path))
    assert got.next_sample == 3 and arrays["losses_all"].shape == (2, 4)


def test_run_directories_load_across_the_two_packages(tmp_path):
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    jcfg = JConfig()
    jstate.save_state(a, jstate.AttributionRunState(next_sample=1, bit_accs=[0.5], success=0, seed=4,
                                                    config=jcfg.to_dict()), _arrays(1))
    st, arrays = state.load_state(a)
    assert (st.next_sample, st.bit_accs, st.success, st.seed) == (1, [0.5], 0, 4)
    np.testing.assert_array_equal(arrays["recovered_bits"], _arrays(1)["recovered_bits"])
    cfg = Config.from_dict(st.config)  # the reference's extra fields (biggan_label, dtype, mesh_*) are ignored
    assert cfg.attribution == AttributionConfig() and cfg.attack == AttackConfig()
    assert cfg.model.blur_kernel == (1, 3, 3, 1) and cfg.run.device == "cuda"
    for name in ("attribution", "attack", "fingerprint"):  # every field the two packages share has one default
        ours = Config().to_dict()[name]
        assert {k: st.config[name][k] for k in ours} == ours, name

    cfg = Config(attribution=AttributionConfig(polish_sweeps=2, coarse_to_fine=True, loss="mse"),
                 attack=AttackConfig(augmentation="Blur", blur_sigma=1.5))
    state.save_state(b, state.AttributionRunState(next_sample=2, bit_accs=[1.0, 1.0], success=2, seed=5,
                                                  config=cfg.to_dict()), _arrays(2))
    jst, jarrays = jstate.load_state(b)
    assert (jst.next_sample, jst.bit_accs, jst.success, jst.seed) == (2, [1.0, 1.0], 2, 5)
    np.testing.assert_array_equal(jarrays["losses_all"], _arrays(2)["losses_all"])
    back = JConfig.from_dict(jst.config)  # the port's `device` is ignored there
    assert back.attribution.polish_sweeps == 2 and back.attribution.coarse_to_fine
    assert back.attack.augmentation == "Blur" and back.attack.blur_sigma == 1.5
    assert json.load(open(os.path.join(b, "attribution_state.json")))["config"]["run"]["device"] == "cuda"


def _result(run_dir):
    return open(os.path.join(run_dir, "result.txt")).read()


def test_cli_run_cut_after_a_chunk_and_resumed_gives_the_same_result(tmp_path, monkeypatch):
    """Three samples in chunks of one, attacked, attack-aware, pruned, polished,
    restarts in chunks of two.  The cut run is the whole run's directory with
    its state set back to the end of the first chunk; the resumed run keeps
    the saved ``remat`` (off) over a ``--remat`` flag."""
    solve, remats = cli_attribute.attr.attribute, []

    def spy(*args, **kwargs):
        remats.append(kwargs.get("remat"))
        return solve(*args, **kwargs)

    monkeypatch.setattr(cli_attribute.attr, "attribute", spy)
    flags = ["--sample_size", "3", "--chunk_samples", "1", "--chunk_starts", "2", "--augmentation", "Blur",
             "--blur_sigma", "1.0", "--attack_aware", "--prune_starts", "1", "--polish_sweeps", "1"]
    whole = cli_attribute.run(TINY + flags + ["--save_dir", str(tmp_path / "whole")])
    assert len(whole.bit_accs) == 3 and len(whole.losses) == 3
    # warm = 1 of 6 steps on 4 restarts (in two chunks of 2, each pruned to 1)
    assert whole.chain_steps == 3 * 2 * (1 * 2 + 5 * 1)
    st, arrays = state.load_state(whole.run_dir)
    assert st.next_sample == 3 and arrays["recovered_bits"].shape == (3, 8)
    assert arrays["losses_all"].shape == (3, 2) and int(arrays["first_sample"]) == 0
    assert st.config["attribution"]["solver_attack"] == "Blur"

    cut = str(tmp_path / "cut")
    shutil.copytree(whole.run_dir, cut)
    os.remove(os.path.join(cut, "result.txt"))
    st.next_sample, st.bit_accs, st.success = 1, st.bit_accs[:1], int(st.bit_accs[0] >= 1.0)
    state.save_state(cut, st, {k: (v[:1] if v.ndim else v) for k, v in arrays.items()})
    # the saved config is authoritative: these other flags are ignored
    resumed = cli_attribute.run(["--device", "cpu", "--random_init", "--resume", cut, "--steps", "1",
                                 "--chunk_samples", "1", "--chunk_starts", "2", "--remat"])
    assert resumed.run_dir == cut and len(resumed.losses) == 2
    assert remats == [False] * 10  # 3 + 2 sample chunks of 2 restart chunks each
    assert _result(cut) == _result(whole.run_dir)
    assert resumed.bit_accs == whole.bit_accs and resumed.losses == whole.losses[1:]
    _, arrays2 = state.load_state(cut)
    for k in arrays:
        np.testing.assert_array_equal(arrays2[k], arrays[k])
    # resuming a finished run solves nothing and keeps the result
    done = cli_attribute.run(["--device", "cpu", "--resume", cut])
    assert done.losses == [] and done.chain_steps == 0 and _result(cut) == _result(whole.run_dir)
