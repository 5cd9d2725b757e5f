"""The port's study layer against the JAX package's, on the CPU.

- ``cli.study``: with the training, the pipeline and the measurement stubbed
  out in both packages (as ``tests/test_study_driver.py`` does), every one of
  the thirteen subcommands builds the same sequence of points (tag, model
  recipe, measurement kwargs; backbone factories compared by whether they
  ran; ``capacity``'s two sweeps by their arguments), writes the same table,
  resumes from the same jsonl and filters by ``--only`` as JAX's does;
  ``capacity`` merges its full-budget sweep into the FID sweep's records and
  ``cli.report capacity`` renders them.
- ``eval.study``: ``eval_point``'s record has the JAX record's keys and the
  same spectrum fields on one PCA; one converging solve recovers every
  planted key; the attacked, attack-aware, pruned, chunked, polished and
  encoder-started points run (2 steps each); the statistics equal JAX's;
  ``ensure_trained`` calls the
  training CLI with JAX's argv plus ``--device``.
- The reference-surface helpers ``project_latent``, ``generate_with_latent``,
  ``get_watermarked_images`` and ``perform_pca``.

The JAX side runs numpy and eager array code only: its solve and synthesis
are stubbed where its records are compared.
"""

import dataclasses
import json
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.cli import study as jcli
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.cli import train as jtrain
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.config import (
    FingerprintConfig as JFingerprintConfig,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.config import ModelConfig as JModelConfig
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.eval import identification as jident
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.eval import (
    model_attribution_study as jmas,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.eval import study as jstudy
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.eval import sweep as jsweep
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.fingerprint import attribute as jattr
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.fingerprint import embed as jembed
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.fingerprint import pca as jpca
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.fingerprint import pipeline as jpl
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.losses import calibrate as jcal
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.losses import disc_percept as jdp
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.losses import lpips as jlp
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.cli import study as cli
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.cli import train as train_cli
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.config import AttackConfig
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.eval import identification as ident
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.eval import (
    model_attribution_study as mas,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.eval import study
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.eval import sweep
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.fingerprint import attribute as attr
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.fingerprint import embed
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.fingerprint import pca
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.fingerprint import pipeline as pl
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.losses import calibrate as cal
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.losses import disc_percept as dp
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.losses import lpips as lp
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.utils.lhs import fold_in

RUNNABLE = list(cli.COMMANDS)


# ---------------------------------------------------------------------------
# cli.study against the JAX package's, the expensive layers stubbed
# ---------------------------------------------------------------------------


class _Args:
    def __init__(self, tmp, cmd, only="", **kw):
        self.cmd, self.only = cmd, only
        self.out = os.path.join(tmp, f"{cmd}.json")
        self.cache_dir = os.path.join(tmp, "ckpts")
        self.samples, self.steps, self.n, self.seed, self.chunk_samples = 4, 50, 6, 1, 2
        self.compile_cache = ""
        self.device = "cpu"
        self.__dict__.update(kw)


def _stub(monkeypatch, mods):
    """Stub one package's training, pipeline, measurements and backbones
    (``mods`` = its study, identification, model-attribution, calibrate,
    disc_percept, lpips and sweep modules); return the list the calls land in."""
    est, eid, ema, ecal, edp, elp, esw = mods
    calls = []

    def ensure_trained(img_size, channel_max, train_steps, cache_dir, **kw):
        return (f"{os.path.basename(cache_dir)}/sg2_{img_size}px_cm{channel_max}_s{train_steps}"
                f"_d{kw.get('data_dim', 0)}_seed{kw.get('seed', 0)}_disc{int(kw.get('need_disc', False))}.npz")

    def build_pipeline(ckpt, img_size, channel_max, **kw):
        return {"ckpt": ckpt, "img": img_size, "cm": channel_max}

    def eval_point(pipe, **kw):
        kw["lpips_params"] = kw["lpips_params"] is not None
        calls.append(("eval_point", pipe, kw))
        return {"mean_bit_acc": 0.9, "bit_acc_ci95": [0.85, 0.95], "exact_match": 0.5, "exact_match_k": 2,
                "exact_match_ci95": [0.1, 0.9], "band_sigma_median": 0.05, "samples": kw["samples"]}

    def identification_point(pipe, **kw):
        calls.append(("identification_point", pipe, kw))
        return {"measured_p_bit": 0.1, "mean_bit_acc": 0.9, "by_registry_size": []}

    def model_attribution_point(registry, held_out, **kw):
        calls.append(("model_attribution_point", (sorted(registry), {n: p["ckpt"] for n, p in registry.items()},
                                                  {n: p["ckpt"] for n, p in held_out.items()}), kw))
        return {"decision_acc": 1.0, "decision_acc_ci95": [0.8, 1.0], "false_reject_at_threshold": 0.0,
                "false_accept_at_threshold": 0.0, "open_set_auc": 1.0}

    def run_sweep(seed, mcfg, *, acfg, key_lens, sigmas, samples, with_fid, **kw):
        """Records a sweep (the seed: JAX's PRNGKey(seed) or the port's int) and
        returns a point a (key_len, sigma): other accuracies at the full budget."""
        seed = seed if isinstance(seed, int) else int(np.asarray(seed).ravel()[-1])
        kw.pop("device", None)
        kw["disc_params"] = kw.get("disc_params") is not None
        calls.append(("run_sweep", (seed, mcfg.img_size, mcfg.channel_max, mcfg.ckpt),
                      dict(kw, acfg=(acfg.steps, acfg.n_starts, acfg.loss), key_lens=key_lens, sigmas=sigmas,
                           samples=samples, with_fid=with_fid)))
        acc = 0.5 if with_fid else 0.75
        return [esw.SweepPoint(key_len=kl, sigma=sig, shift=512 - kl, mean_bit_acc=acc + kl / 1000,
                               attribution_acc=acc / 2, watermark_lpips=0.01 * sig, watermark_mse=0.001 * sig,
                               mean_latent_cos=0.9, fid=(3.5 * sig if with_fid else None),
                               fid_disc=(0.25 * kl if kw["disc_params"] else None))
                for kl in key_lens for sig in sigmas]

    for mod, name, fn in ((est, "ensure_trained", ensure_trained), (est, "build_study_pipeline", build_pipeline),
                          (esw, "run_sweep", run_sweep),
                          (est, "eval_point", eval_point), (est, "bit_sigma_correlation", lambda rec: 0.0),
                          (eid, "identification_point", identification_point),
                          (ema, "model_attribution_point", model_attribution_point),
                          (ecal, "calibrate_lin_heads", lambda base, **kw: {"fitted": base}),
                          (ecal, "rank_accuracy", lambda base, **kw: 0.5),
                          (edp, "load_disc_percept", lambda path, **kw: {"disc": path}),
                          (elp, "init_lpips_params", lambda *a, **kw: {"vgg": "random"})):
        monkeypatch.setattr(mod, name, fn)
    return calls


@pytest.fixture
def stubbed(monkeypatch, tmp_path):
    """Both packages stubbed, in a working directory that holds the stubbed
    recipe's (empty) discriminator export, which JAX's ``capacity`` reads."""
    monkeypatch.chdir(tmp_path)
    os.makedirs("ckpts")
    np.savez("ckpts/sg2_64px_cm128_s3000_d0_seed0_disc1.npz.disc.npz")
    return (_stub(monkeypatch, (jstudy, jident, jmas, jcal, jdp, jlp, jsweep)),
            _stub(monkeypatch, (study, ident, mas, cal, dp, lp, sweep)))


def _run_both(stubbed, tmp_path, cmd, **kw):
    """Run subcommand ``cmd`` in both packages (each in its own directory);
    return (JAX's calls, port's calls, JAX's table, port's table)."""
    jcalls, calls = stubbed
    out = []
    for pkg, sub in ((jcli, "jax"), (cli, "port")):
        d = tmp_path / sub
        d.mkdir(parents=True, exist_ok=True)
        args = _Args(str(d), cmd, **kw)
        assert getattr(pkg, f"cmd_{cmd}")(args) == 0
        out.append([{k: v for k, v in r.items() if k != "wall_s"} for r in json.load(open(args.out))])
    return jcalls, calls, out[0], out[1]


@pytest.mark.parametrize("cmd", RUNNABLE)
def test_each_subcommand_builds_jaxs_points(stubbed, tmp_path, cmd):
    """The (tag, model recipe, measurement kwargs) sequence of every runnable
    subcommand, at the stub's defaults and with the chunking left to
    ``_auto_chunk``: identical to JAX's."""
    jcalls, calls, jtable, table = _run_both(stubbed, tmp_path, cmd, chunk_samples=0, n=20)
    assert calls and calls == jcalls
    assert table == jtable
    # every point is tagged but capacity's grid, whose records (as JAX's) carry none
    assert len({r.get("tag", (r.get("key_len"), r.get("sigma"))) for r in table}) == len(table)
    if cmd == "perceptual":  # every backbone but mse built its params
        assert [c[2]["lpips_params"] for c in calls] == [name != "mse" for name in
                                                         ("mse", "disc", "vgg_rand", "disc_cal", "vgg_cal")
                                                         for _ in range(4)]


def test_capacity_merges_the_full_budget_sweep_and_renders(stubbed, tmp_path):
    """The FID sweep (500 steps x 8 restarts, bf16, with the discriminator) and
    the full-budget sweep (--steps / --n) over one grid and seed; the second's
    accuracies merged into the first's records; the default table
    ``result/study_capacity_torch.json``; ``cli.report capacity`` renders it."""
    from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.cli import report

    _, calls = stubbed
    assert cli.main(["capacity", "--device", "cpu", "--cache_dir", "ckpts", "--steps", "60", "--n", "6",
                     "--samples", "4", "--seed", "5"]) == 0
    ckpt = "ckpts/sg2_64px_cm128_s3000_d0_seed0_disc1.npz"
    grid = dict(key_lens=(32, 64), sigmas=(3.0, 6.0), samples=8, ckpt_path=ckpt, dtype="bfloat16")
    assert calls == [("run_sweep", (5, 64, 128, ckpt), dict(grid, acfg=(500, 8, "mse"), with_fid=True,
                                                            disc_params=True)),
                     ("run_sweep", (5, 64, 128, ckpt), dict(grid, acfg=(60, 6, "mse"), with_fid=False,
                                                            disc_params=False))]
    recs = json.load(open("result/study_capacity_torch.json"))
    assert [(r["key_len"], r["sigma"]) for r in recs] == [(32, 3.0), (32, 6.0), (64, 3.0), (64, 6.0)]
    for r in recs:
        assert r["mean_bit_acc"] == 0.5 + r["key_len"] / 1000
        assert r["mean_bit_acc_full"] == 0.75 + r["key_len"] / 1000 and r["attribution_acc_full"] == 0.375
        assert r["full_budget"] == "60/6" and r["samples"] == 8
        assert r["fid"] == 3.5 * r["sigma"] and r["fid_disc"] == 0.25 * r["key_len"]
    assert "capacity" in cli.COMMANDS and len(cli.COMMANDS) == 13
    for cmd in cli.COMMANDS:  # the parser takes all thirteen names
        assert cli._parser().parse_args([cmd]).cmd == cmd
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert report.main(["capacity"]) == 0
    text = buf.getvalue()
    assert "## study_capacity (4 points)" in text and "bit acc (60/6 budget)" in text


def test_only_resume_and_torn_lines_as_in_jax(stubbed, tmp_path):
    jcalls, calls = stubbed
    # --only
    _, _, jt, t = _run_both(stubbed, tmp_path / "only", "pruning", only="n40")
    assert calls == jcalls and len(calls) == 4 and t == jt
    # resume from a jsonl with one point done and a torn final line: the torn point reruns
    for sub in ("jax", "port"):
        d = tmp_path / "resume" / sub
        d.mkdir(parents=True)
        with open(d / "attackaware.json.jsonl", "w") as f:
            f.write(json.dumps({"tag": "64px_kl32_s6_Jpeg_aware", "mean_bit_acc": 0.7}) + "\n")
            f.write('{"tag": "64px_kl32_s6_Crop_aware", "mean_bi')
    jcalls.clear()
    calls.clear()
    _, _, jt, t = _run_both(stubbed, tmp_path / "resume", "attackaware")
    assert calls == jcalls and {c[2]["attack"] for c in calls} == {"Blur", "Crop", "Combination"}
    assert t == jt and len(t) == 4
    # a torn middle line is corruption: both raise
    for pkg, sub in ((jcli, "jax"), (cli, "port")):
        d = tmp_path / "torn" / sub
        d.mkdir(parents=True)
        with open(d / "attackaware.json.jsonl", "w") as f:
            f.write('{"torn": \n' + json.dumps({"tag": "x", "mean_bit_acc": 0.7}) + "\n")
        with pytest.raises(json.JSONDecodeError):
            pkg.cmd_attackaware(_Args(str(d), "attackaware"))


def test_defaults_name_the_port_records(monkeypatch, tmp_path, stubbed):
    """Without --out a study writes result/study_<name>_torch.json(.jsonl)
    under the working directory; the default cache and device are the port's."""
    monkeypatch.chdir(tmp_path)
    assert cli.main(["robustness", "--device", "cpu", "--only", "Jpeg", "--compile_cache", "/x"]) == 0
    assert sorted(os.listdir(tmp_path / "result")) == ["study_robustness_torch.json",
                                                       "study_robustness_torch.json.jsonl"]
    args = cli._parser().parse_args(["headline"])
    assert (args.cache_dir, args.device, args.out) == (os.path.join(tempfile.gettempdir(), "fp_ckpts_torch"), "cuda", "")


def test_auto_chunk_equals_jaxs():
    for img in (16, 32, 64, 128, 256, 512, 1024):
        for cm in (32, 64, 128, 256, 512):
            for n in (1, 2, 5, 8, 20, 40, 50, 200, 400):
                assert cli._auto_chunk(img, cm, n) == jcli._auto_chunk(img, cm, n)


def test_bestrecipe_is_budget_matched(stubbed, tmp_path):
    _, calls, _, _ = _run_both(stubbed, tmp_path, "bestrecipe", steps=2000, n=20, chunk_samples=0)
    assert len(calls) == 8
    for _, _, c in calls:
        assert attr.executed_chain_steps(c["steps"], c["n_starts"], c["prune_starts"], c["prune_frac"]) == \
            attr.executed_chain_steps(2000, 20, 0, 0.25) == jattr.executed_chain_steps(2000, 20, 0, 0.25)
        assert c["chunk_samples"] * c["n_starts"] <= 200
    attacked = [c for _, _, c in calls if c.get("attack", "None") != "None"]
    assert sorted(c["attack"] for c in attacked) == ["Crop", "Jpeg"]
    assert all(c["attack_aware"] and c["loss"] == "perceptual" and c["lpips_params"] for c in attacked)


# ---------------------------------------------------------------------------
# eval.study
# ---------------------------------------------------------------------------

TINY = dict(img_size=16, channel_max=64, style_dim=64, n_mlp=3)  # the tiny converging widths, at 16 px


@pytest.fixture(scope="module")
def tiny_pipe():
    """The study pipeline of the tiny converging configuration's widths
    (style_dim 64, channel_max 64, n_mlp 3; the key on the last 8 axes, shift
    56) at 16 px on the CPU, its ToRGB layers scaled by 0.3 so that the random
    generator's images lie about [-1, 1] as a trained generator's do
    (eval_point clips its targets there)."""
    pipe = study.build_study_pipeline(None, n_pca_samples=2000, seed=0, device="cpu", **TINY)
    for p in [pipe.gen_params["to_rgb1"]] + list(pipe.gen_params["to_rgbs"]):
        p["weight"].mul_(0.3)
        p["bias"].mul_(0.3)
    return pipe


@pytest.fixture(scope="module")
def converged(tiny_pipe):
    return study.eval_point(tiny_pipe, key_len=8, sigma=3.0, shift=56, samples=2, steps=200, n_starts=4,
                            dtype="float32")


def test_converging_point_recovers_every_planted_key(converged):
    rec = converged
    assert rec["exact_match_k"] == 2 and rec["mean_bit_acc"] == 1.0 and rec["per_bit_acc"] == [1.0] * 8
    assert rec["mean_final_loss"] < 5e-3
    assert rec["exact_match_ci95"] == list(study.wilson_ci(2, 2))


def _jax_record(tiny_pipe, monkeypatch, **kw):
    """JAX's eval_point on a pipeline holding the port pipeline's PCA, its
    synthesis and solve stubbed (only its record's own arithmetic runs)."""
    p = tiny_pipe.pca
    jp = jpca.PCABasis(pc=jnp.asarray(p.pc.numpy()), sigma=jnp.asarray(p.sigma.numpy()),
                       mean=jnp.asarray(p.mean.numpy()))
    jpipe = jpl.Pipeline(mcfg=JModelConfig(ckpt=None, **TINY), fpcfg=JFingerprintConfig(key_len=64, shift=0),
                         gen_params=None, basis=None, pca=jp, noise=())

    def solve(gen, lpips_params, basis, noise, targets, rng, **kw2):
        s, k = targets.shape[0], basis.v_cap.shape[0]
        return jattr.AttributionResult(alpha=None, key_logits=None, key_bits=jnp.zeros((s, k)),
                                       loss=jnp.ones((s,)), losses_all=None, best_start=None)

    monkeypatch.setattr(jpl, "synthesize", lambda pipe, w: jnp.zeros((w.shape[0], 16, 16, 3)))
    monkeypatch.setattr(jattr, "attribute_chunked", solve)
    return jstudy.eval_point(jpipe, **kw)


def test_record_schema_and_spectrum_match_jax(tiny_pipe, converged, monkeypatch):
    """The record's keys are the committed JAX records' keys less the driver's;
    the spectrum fields and the executed chain-steps equal JAX's on one PCA."""
    path = os.path.join(os.path.dirname(__file__), "..", "result", "study_headline.json.jsonl")
    want = set(json.loads(open(path).readline())) - {"tag", "train_steps", "bit_sigma_spearman", "wall_s"}
    assert set(converged) == want
    kw = dict(key_len=8, sigma=3.0, shift=56, samples=2, steps=200, n_starts=4, prune_starts=2)
    jrec = _jax_record(tiny_pipe, monkeypatch, **kw)
    assert set(jrec) == want
    rec = dict(converged, chain_steps_per_sample=attr.executed_chain_steps(200, 4, 2, 0.25))
    for key in ("band_sigma", "spectrum_decile_sigmas"):
        np.testing.assert_allclose(rec[key], jrec[key], rtol=1e-6, atol=1e-6)
    for key in ("band_sigma_median", "content_sigma_median", "chain_steps_per_sample"):
        assert rec[key] == pytest.approx(jrec[key], rel=1e-6, abs=1e-6)
    for key in ("img_size", "channel_max", "ckpt", "key_len", "sigma", "shift", "attack", "loss", "samples",
                "steps", "n_starts"):
        assert rec[key] == jrec[key], key


@pytest.mark.parametrize("case", ["attacked", "attack_aware", "pruned", "chunked", "polished", "encoder"])
def test_point_modes_run(tiny_pipe, case):
    """2-step points of every solver mode: complete records, finite losses,
    one point's draws the same on a second call; with encoder starts, the
    record's encoder fields are the committed JAX records'."""
    kw = {"attacked": dict(attack="Jpeg"), "attack_aware": dict(attack="Crop", attack_aware=True),
          "pruned": dict(n_starts=4, prune_starts=2), "chunked": dict(chunk_samples=1, chunk_starts=1),
          "polished": dict(polish_sweeps=1, attack="Noise", attack_cfg=AttackConfig(noise_sigma=0.05)),
          "encoder": dict(init="encoder", encoder_steps=2, encoder_batch=2, attack="Blur")}[case]
    base = dict(key_len=8, sigma=3.0, samples=2, steps=2, n_starts=2, dtype="float32")
    rec = study.eval_point(tiny_pipe, **{**base, **kw})
    assert rec["shift"] == 56 and rec["attack"] == kw.get("attack", "None") and len(rec["per_bit_acc"]) == 8
    if case == "encoder":
        path = os.path.join(os.path.dirname(__file__), "..", "result", "study_encoderinit.json.jsonl")
        jrec = next(r for r in map(json.loads, open(path)) if r.get("init") == "encoder")
        assert {k for k in rec if k.startswith("enc") or k == "init"} == \
            {k for k in jrec if k.startswith("enc") or k == "init"}
        assert rec["encoder_batch"] == 2 and np.isfinite(rec["encoder_final_train_loss"])
    assert np.isfinite(rec["mean_final_loss"]) and 0.0 <= rec["mean_bit_acc"] <= 1.0
    want = attr.executed_chain_steps(2, rec["n_starts"], kw.get("prune_starts", 0), 0.25)
    assert rec["chain_steps_per_sample"] == want
    if case == "chunked":  # the same point twice: the same draws, the same record
        again = study.eval_point(tiny_pipe, **{**base, **kw})
        assert again == rec


def test_point_seed_folds_the_reference_hash():
    h = hash((32, 480, 96)) % (1 << 30)
    assert study.point_seed(100, 32, 480, 6.0) == fold_in(100, h).initial_seed()
    assert study.point_seed(100, 32, 480, 6.0) != study.point_seed(100, 32, 480, 3.0)


def test_statistics_match_jax():
    rng = np.random.default_rng(0)
    for k, n in ((0, 0), (0, 5), (3, 7), (20, 20), (13, 40)):
        assert study.wilson_ci(k, n) == jstudy.wilson_ci(k, n)
    for _ in range(6):
        acc = rng.integers(15, 21, size=32) / 20.0  # large tie groups, as real per-bit accuracies
        sig = np.round(rng.uniform(0.05, 0.3, size=32), 2)
        point = {"per_bit_acc": acc.tolist(), "band_sigma": sig.tolist()}
        assert study.bit_sigma_correlation(point) == pytest.approx(jstudy.bit_sigma_correlation(point), abs=1e-12)
        np.testing.assert_array_equal(study._average_ranks(acc), jstudy._average_ranks(acc))
    flat = {"per_bit_acc": [0.5] * 4, "band_sigma": [0.1, 0.2, 0.3, 0.4]}
    assert study.bit_sigma_correlation(flat) is None and jstudy.bit_sigma_correlation(flat) is None


def test_ensure_trained_calls_train_with_jaxs_argv(tmp_path, monkeypatch):
    """JAX's argv plus --device; a cached export is reused; need_disc retrains
    a cache that lacks the discriminator's export."""
    seen = {"jax": [], "port": []}

    def fake_main(which, disc):
        def main(argv):
            seen[which].append(list(argv))
            out = argv[argv.index("--out") + 1]
            open(out, "w").close()
            if disc:
                open(out + ".disc.npz", "w").close()
            return 0
        return main

    kw = dict(img_size=64, channel_max=128, train_steps=3000, data_dim=8, seed=3)
    monkeypatch.setattr(jtrain, "main", fake_main("jax", False))
    monkeypatch.setattr(train_cli, "main", fake_main("port", False))
    jpath = jstudy.ensure_trained(cache_dir=str(tmp_path / "j"), **kw)
    path = study.ensure_trained(cache_dir=str(tmp_path / "p"), device="cpu", **kw)
    assert os.path.basename(path) == os.path.basename(jpath) == "sg2_64px_cm128_s3000_b16_seed3_d8.npz"
    assert seen["port"][0] == [a.replace("/j/", "/p/") for a in seen["jax"][0]] + ["--device", "cpu"]
    assert study.ensure_trained(cache_dir=str(tmp_path / "p"), device="cpu", **kw) == path
    assert len(seen["port"]) == 1  # reused
    monkeypatch.setattr(train_cli, "main", fake_main("port", True))
    study.ensure_trained(cache_dir=str(tmp_path / "p"), device="cpu", need_disc=True, **kw)
    assert len(seen["port"]) == 2 and os.path.exists(path + ".disc.npz")  # retrained for the export
    study.ensure_trained(cache_dir=str(tmp_path / "p"), device="cpu", need_disc=True, **kw)
    assert len(seen["port"]) == 2


# ---------------------------------------------------------------------------
# reference-surface helpers
# ---------------------------------------------------------------------------


def _jbasis(basis):
    return jembed.FingerprintBasis(**{f.name: getattr(basis, f.name) if f.name == "sd_moved"
                                      else jnp.asarray(getattr(basis, f.name).numpy())
                                      for f in dataclasses.fields(embed.FingerprintBasis)})


def test_project_latent_and_generate_with_latent_match_jax(tiny_pipe):
    fp = tiny_pipe.fpcfg
    basis = embed.build_basis(tiny_pipe.pca, fp)
    pipe = dataclasses.replace(tiny_pipe, basis=basis)
    w = np.random.default_rng(1).standard_normal((3, 64)).astype(np.float32)
    want = np.asarray(jax.jit(jembed.project_latent)(_jbasis(basis), jnp.asarray(w)))
    got = embed.project_latent(basis, torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    imgs, w0, wx, bits = pl.generate_with_latent(pipe, torch.Generator().manual_seed(2), torch.from_numpy(w))
    np.testing.assert_array_equal(bits.numpy(), embed.sample_key_bits(fp.key_len, 3, torch.Generator().manual_seed(2),
                                                                      "cpu").numpy())
    np.testing.assert_allclose(w0.numpy(), want, rtol=1e-4, atol=1e-5)
    jwx = want + np.asarray(jembed.key_offset(_jbasis(basis), jnp.asarray(bits.numpy())))
    np.testing.assert_allclose(wx.numpy(), jwx, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(imgs, pl.synthesize(pipe, wx))


def test_get_watermarked_images(tiny_pipe):
    from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.attacks import make_attack

    pipe = dataclasses.replace(tiny_pipe, attack=make_attack(AttackConfig(augmentation="Blur")))
    g = torch.Generator().manual_seed(4)
    original, marked, attacked = pl.get_watermarked_images(pipe, g, 2)
    imgs, w0, _, bits, alpha = pl.generate_fingerprinted(pipe, 2, fold_in(g, 0))
    torch.testing.assert_close(marked, imgs)
    torch.testing.assert_close(original, pl.synthesize(pipe, w0))
    torch.testing.assert_close(attacked, pl.augment(pipe, imgs))
    # w0 is JAX's content latent of the same draws
    jw0, _ = jembed.embed(_jbasis(pipe.basis), jnp.asarray(alpha.numpy()), jnp.asarray(bits.numpy()))
    np.testing.assert_allclose(w0.numpy(), np.asarray(jw0), rtol=1e-5, atol=1e-5)
    assert float((marked - original).abs().max()) > 1e-4 and float((attacked - marked).abs().max()) > 1e-4


def test_perform_pca_matches_jax():
    """The PCA of what the mapping returns equals JAX's perform_pca of the same
    samples; the mapping gets z [n, dim] drawn on the CPU from the generator."""
    x = np.random.default_rng(3).standard_normal((300, 12)).astype(np.float32) * np.linspace(3, 0.1, 12)
    seen = []

    def mapping(z):
        seen.append(z)
        return torch.from_numpy(x)

    got = pca.perform_pca(mapping, 300, 12, torch.Generator().manual_seed(5))
    torch.testing.assert_close(seen[0], torch.randn((300, 12), generator=torch.Generator().manual_seed(5)))
    want = jax.jit(lambda: jpca.perform_pca(jnp.zeros((2,), jnp.uint32), lambda z: jnp.asarray(x), 300, 12))()
    for name in ("pc", "sigma", "mean"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)), rtol=1e-4,
                                   atol=1e-5)
