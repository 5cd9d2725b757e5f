"""The port's attribution solve vs the JAX package on the CPU (the bare solve
and its modes: attack-aware, coarse-to-fine, pruning, polish, chunking), plus
its end-to-end checks: planted-key recovery, the CLI's output layout, and that
the port never imports JAX.
"""

import dataclasses
import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.config import (
    AttackConfig as JAttackConfig,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.config import (
    AttributionConfig as JAttributionConfig,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.config import (
    FingerprintConfig as JFingerprintConfig,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.config import (
    ModelConfig as JModelConfig,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.fingerprint import (
    attribute as jattr,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.fingerprint import (
    pipeline as jpl,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.losses import lpips as jlp
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.models import stylegan2 as jsg2
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.utils.lhs import (
    lhs_alpha_init_batch,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.checkpoints import (
    rosinality,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.cli import (
    attribute as cli_attribute,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.config import (
    AttackConfig,
    AttributionConfig,
    FingerprintConfig,
    ModelConfig,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.fingerprint import (
    attribute as attr,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.fingerprint import (
    embed,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.fingerprint import (
    pipeline as pl,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.losses import lpips

PORT = "attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch"
MKW = dict(img_size=32, channel_max=32, n_mlp=2, style_dim=32)
FKW = dict(key_len=8, shift=16, sigma=1.0, sd_moved=1.0, n_pca_samples=1000)


@pytest.fixture
def direct_cpu_convs():
    """oneDNN's CPU convolutions take a faster, less exact algorithm: with it
    the float32 solver gradient sits ~2e-4 (of its scale) from a float64
    solve, against ~4e-5 for PyTorch's direct convs and for the JAX package.
    Parity is checked with the direct ones."""
    before = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    yield
    torch.backends.mkldnn.enabled = before


def _basis_from_jax(jb):
    return embed.FingerprintBasis(**{
        f.name: (torch.from_numpy(np.array(getattr(jb, f.name))) if f.name != "sd_moved" else jb.sd_moved)
        for f in dataclasses.fields(embed.FingerprintBasis)
    })


def test_perceptual_solve_matches_jax_loss_for_loss(direct_cpu_convs, mse_problem):
    """Same generator, LPIPS, basis, noise, targets and LHS starts; 10
    perceptual steps of the JAX solver.  At every step, from the JAX
    solver's state: the port's loss of every restart agrees to 1e-4
    relative; the port's Adam update, given the JAX gradient, lands on the
    JAX solver's next state (1e-5); and each restart's gradient (alpha and
    key logits) agrees with the JAX one to a relative L2 gap of 1e-5 at the
    median over the 10 steps x 6 restarts, and of 1e-3 at the worst.

    The worst is not held to 1e-5 because of ReLU kinks, not port errors: at
    a few steps one pre-activation of one restart's image (LPIPS's ReLUs) sits
    within rounding of zero, and float32 rounding puts it on the other side in
    the port than in the JAX package.  That restart's gradient then reads
    2e-4 - 4.2e-4 apart while the others read 4e-7 - 9e-6; how many steps
    meet a kink depends on the host's float32 convolutions (one on Intel
    hosts, four on AMD EPYC ones).  A fault of the port's gradient moves every
    restart and fails the median.  Steps are compared from the same state
    because free-running float32 solves drift apart through Adam (its first
    moment cancels when a gradient changes sign)."""
    mcfg_j, steps = mse_problem["mcfg_j"], 10
    # the shared problem's pipeline (the same keys and generator weights; LPIPS
    # draws no key of its own when given) with LPIPS weights from a jitted
    # initializer, and its targets: generate_fingerprinted(jp, PRNGKey(1), 2)
    jp = dataclasses.replace(mse_problem["jp"], lpips_params=jax.jit(jlp.init_lpips_params)(jax.random.PRNGKey(6)))
    imgs = mse_problem["imgs"]
    a0 = lhs_alpha_init_batch(jax.random.PRNGKey(2), 2, 3, jp.basis.sigma_rest)
    acfg_j = JAttributionConfig(steps=steps, n_starts=3, loss="perceptual")
    opt = jattr._make_optimizer(acfg_j)
    target_feats = tuple(f[:, None] for f in jax.jit(jlp.extract_features)(jp.lpips_params, imgs))
    jstep = jax.jit(jattr.make_attribution_step(
        jp.gen_params, jp.lpips_params, jp.basis, jp.noise, mcfg_j, acfg_j, target_feats, None, opt))

    acfg = AttributionConfig(steps=steps, n_starts=3, loss="perceptual")
    tl = lpips.params_from_jax(jp.lpips_params, "cpu")
    with torch.no_grad():
        tfeats = [f[:, None] for f in lpips.extract_features(tl, torch.from_numpy(np.array(imgs)))]
    _, tper_elem = attr.make_attribution_step(
        rosinality.params_from_jax(jp.gen_params, "cpu"), tl, _basis_from_jax(jp.basis),
        [torch.from_numpy(np.array(n)) for n in jp.noise], ModelConfig(**MKW), acfg, tfeats, None)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    params = {"alpha": a0, "key": jnp.zeros((2, 3, 8))}
    opt_state = opt.init(params)
    gaps = []  # relative L2 gap of each restart's gradient, every step
    for i in range(steps):
        adam = opt_state[0]
        alpha = t(params["alpha"]).requires_grad_(True)
        key = t(params["key"]).requires_grad_(True)
        per = tper_elem(alpha, key)
        g_alpha, g_key = torch.autograd.grad(per.sum(), [alpha, key])
        state = {"alpha": t(params["alpha"]), "key": t(params["key"]),
                 "m_alpha": t(adam.mu["alpha"]), "v_alpha": t(adam.nu["alpha"]),
                 "m_key": t(adam.mu["key"]), "v_key": t(adam.nu["key"]), "count": int(adam.count)}
        (params, opt_state), jper = jstep((params, opt_state), 0.0)
        # the JAX gradient, read back from Adam's first moment mu' = b1*mu + (1-b1)*g
        # (float32 rounding of mu' costs ~1e-6 of the gradient's scale; one
        # jitted program fewer to compile)
        jg = {name: (np.asarray(opt_state[0].mu[name], np.float64)
                     - attr.B1 * np.asarray(adam.mu[name], np.float64)) / (1.0 - attr.B1)
              for name in ("alpha", "key")}
        new = attr.adam_update(state, {name: t(jg[name].astype(np.float32)) for name in jg}, acfg)

        np.testing.assert_allclose(per.detach().numpy(), np.asarray(jper), rtol=1e-4, err_msg=f"step {i}")
        got = np.concatenate([g_alpha.numpy(), g_key.numpy()], axis=-1).astype(np.float64)
        want = np.concatenate([jg["alpha"], jg["key"]], axis=-1)
        gaps.append(np.linalg.norm(got - want, axis=-1) / np.linalg.norm(want, axis=-1))
        for name in ("alpha", "key"):
            np.testing.assert_allclose(new[name].numpy(), np.asarray(params[name]), atol=1e-5,
                                       err_msg=f"step {i} {name}")
        assert new["count"] == int(opt_state[0].count)
    gaps = np.stack(gaps)
    assert np.median(gaps) <= 1e-5, gaps
    assert gaps.max() <= 1e-3, gaps


def test_adam_matches_optax_convention():
    """Two steps of the hand-written Adam on the gradient of 0.5*||alpha||^2,
    against the closed form: bias correction by count+1, rate
    lr*exp(-decay*(count+1)) with count from 0, eps outside the sqrt."""
    acfg = AttributionConfig(lr=0.2, lr_decay=0.001)
    alpha = torch.tensor([[[1.0, -2.0, 1e-3]]])
    state = attr.init_state(alpha.clone(), torch.zeros(1, 1, 1))
    m = v = torch.zeros_like(alpha)
    for t in (1, 2):
        g = alpha.clone()
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        upd = (m / (1 - 0.9 ** t)) / (torch.sqrt(v / (1 - 0.999 ** t)) + 1e-8)
        alpha = alpha - 0.2 * np.exp(-0.001 * t) * upd
        state = attr.adam_update(state, {"alpha": state["alpha"].clone()}, acfg)
    torch.testing.assert_close(state["alpha"], alpha, rtol=1e-6, atol=1e-7)
    assert state["count"] == 2


@pytest.fixture(scope="module")
def tiny_pipe():
    mcfg = ModelConfig(img_size=32, channel_max=64, n_mlp=3, style_dim=64)
    fpcfg = FingerprintConfig(key_len=8, shift=56, n_pca_samples=2000)
    return mcfg, pl.build_pipeline(mcfg, fpcfg, generator=torch.Generator().manual_seed(1),
                                   want_lpips=False, device="cpu")


def test_attribution_recovers_keys(tiny_pipe):
    """Plant a key, invert it: the reference's self-validating check on the
    port alone (mse, 300 steps, 4 restarts, 3 samples)."""
    mcfg, pipe = tiny_pipe
    imgs, _, _, bits, _ = pl.generate_fingerprinted(pipe, 3, torch.Generator().manual_seed(2))
    res = attr.attribute(pipe.gen_params, None, pipe.basis, pipe.noise, imgs, mcfg=mcfg,
                         acfg=AttributionConfig(steps=300, n_starts=4, lr=0.2, loss="mse"),
                         generator=torch.Generator().manual_seed(3))
    ev = attr.evaluate_attribution(res, bits)
    accs = ev["bit_acc"].numpy()
    assert float(ev["mean_bit_acc"]) > 0.85, accs
    assert (accs == 1.0).sum() >= 2, accs
    assert res.losses_all.shape == (3, 4)
    np.testing.assert_array_equal(res.best_start.numpy(), res.losses_all.argmin(1).numpy())
    assert np.sort(res.loss.numpy())[:2].max() < 5e-3


def test_cli_attribute_writes_reference_layout(tmp_path):
    r = cli_attribute.run([
        "--device", "cpu", "--random_init", "--img_size", "16", "--style_dim", "32", "--n_mlp", "2",
        "--channel_max", "32", "--key_len", "8", "--shift", "16", "--loss", "perceptual",
        "--sample_size", "2", "--n", "2", "--steps", "3", "--save_dir", str(tmp_path),
    ])
    assert r.run_dir.startswith(os.path.join(str(tmp_path), "None", "fixed_sigma_10", "shift_16"))
    for f in ("sampling_config.yaml", "result.txt", "original/000000.png", "watermarked/000001.png"):
        assert os.path.exists(os.path.join(r.run_dir, f)), f
    text = open(os.path.join(r.run_dir, "result.txt")).read()
    rows = re.findall(r"\n sample index: (\d+), bit acc: ([0-9.]+), attribution acc: ([0-9.]+)", text)
    assert [int(i) for i, _, _ in rows] == [0, 1]
    assert all(np.isfinite(r.losses))


def test_cli_refuses_unported_flags(tmp_path, monkeypatch):
    # --dtype bfloat16 and --remat are ported: a 2-step bf16 run gradient-checkpoints its solve, completes
    # and saves both (a resume takes them)
    solve, remats = attr.attribute, []

    def spy(*args, **kwargs):
        remats.append(kwargs.get("remat"))
        return solve(*args, **kwargs)

    monkeypatch.setattr(attr, "attribute", spy)
    r = cli_attribute.run([
        "--device", "cpu", "--random_init", "--img_size", "16", "--style_dim", "32", "--n_mlp", "2",
        "--channel_max", "32", "--key_len", "8", "--shift", "16", "--loss", "perceptual",
        "--sample_size", "1", "--n", "2", "--steps", "2", "--dtype", "bfloat16", "--remat", "--save_dir", str(tmp_path),
    ])
    assert os.path.exists(os.path.join(r.run_dir, "result.txt")) and all(np.isfinite(r.losses))
    saved = json.load(open(os.path.join(r.run_dir, "attribution_state.json")))["config"]["run"]
    assert saved["dtype"] == "bfloat16" and saved["remat"] is True and remats == [True]
    with pytest.raises(SystemExit):
        cli_attribute.run(["--device", "cpu", "--random_init", "--dtype", "float16"])
    # BigGAN is ported; the encoder that seeds --init encoder renders StyleGAN2 only
    with pytest.raises(SystemExit, match="StyleGAN2's synthesis; --model biggan"):
        cli_attribute.run(["--device", "cpu", "--random_init", "--model", "biggan", "--init", "encoder"])


def test_port_never_imports_jax():
    code = (
        "import sys, torch\n"
        f"from {PORT}.config import ModelConfig, FingerprintConfig, AttributionConfig\n"
        f"from {PORT}.fingerprint import pipeline as pl, attribute as attr\n"
        f"from {PORT}.cli import attribute, generate, keys, serve\n"
        f"from {PORT}.fingerprint import encoder, keys as fkeys\n"
        f"from {PORT}.eval import identification, study, model_attribution_study\n"
        f"from {PORT}.serving import engine, server\n"
        f"from {PORT}.cli import model_attribute\n"
        f"from {PORT}.fingerprint import model_attribution as ma\n"
        f"from {PORT}.models import biggan as bg\n"
        f"from {PORT}.parallel import mesh, multihost, solver, train as ptrain\n"
        f"from {PORT}.utils import profiling\n"
        "m = ModelConfig(img_size=8, style_dim=16, n_mlp=1, channel_max=16)\n"
        "fp = FingerprintConfig(key_len=4, shift=8, n_pca_samples=100)\n"
        "p = pl.build_pipeline(m, fp, device='cpu')\n"
        "imgs = pl.generate_fingerprinted(p, 1, torch.Generator().manual_seed(0))[0]\n"
        "acfg = AttributionConfig(steps=2, n_starts=2, loss='mse')\n"
        "r = attr.attribute(p.gen_params, p.lpips_params, p.basis, p.noise, imgs, mcfg=m, acfg=acfg)\n"
        "assert r.key_bits.shape == (1, 4)\n"
        "bcfg = bg.BigGANConfig(z_dim=16, class_embed_dim=4, channel_width=4, num_classes=3, output_dim=8,\n"
        "                       attention_layer_position=0, layers=((True, 16, 1),), n_stats=3)\n"
        "b = pl.build_pipeline(ModelConfig(model='biggan', img_size=8, biggan_label='2'), fp, device='cpu',\n"
        "                      want_lpips=False, biggan_cfg=bcfg)\n"
        "mr = ma.attribute_model({'sg2': p, 'biggan': b}, imgs, None, acfg)\n"
        "assert mr.losses.shape == (2, 1) and mr.key_bits.shape == (1, 4)\n"
        "p2 = pl.build_pipeline(m, fp, device='cpu', generator=torch.Generator().manual_seed(1))\n"
        "rec = model_attribution_study.model_attribution_point({'a': p, 'b': p2}, {}, key_len=4, sigma=1.0,\n"
        "    samples_per_model=2, steps=1, n_starts=2, clip_targets=False)\n"
        "assert rec['n_eval_in_dist'] == 2\n"
        "rec = model_attribute.run(['--device', 'cpu', '--random_init', '--img_size', '8', '--style_dim', '16',\n"
        "    '--n_mlp', '1', '--channel_max', '16', '--key_len', '4', '--shift', '8', '--loss', 'mse', '--n', '2',\n"
        "    '--steps', '1', '--sample_size', '2'])\n"
        "assert len(rec['decisions']) == 2\n"
        f"from {PORT}.cli import train\n"
        f"from {PORT}.training import folder, snapshot\n"
        f"from {PORT}.checkpoints import flat\n"
        "assert train.main(['--device', 'cpu', '--img_size', '8', '--style_dim', '16', '--n_mlp', '1',\n"
        "    '--channel_max', '16', '--batch', '2', '--steps', '1', '--out', '']) == 0\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.') or k == 'jaxlib'\n"
        "       or k.startswith('attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.')\n"
        "       or k == 'attributing_image_generative_models_using_latent_fingerprints_sg2_tpu']\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=root, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout


# ---------------------------------------------------------------------------
# the solver's modes against the JAX package: one shared 32px mse problem
# ---------------------------------------------------------------------------

S_, N_ = 2, 4


@pytest.fixture(scope="module")
def mse_problem():
    """One JAX pipeline (32px, 8 key bits) with two targets and 4 LHS starts a
    sample, and the same weights, basis, noise, targets and starts as tensors."""
    mcfg_j = JModelConfig(**MKW)
    jp = jpl.build_pipeline(
        jax.random.PRNGKey(0), mcfg_j, JFingerprintConfig(**FKW), want_lpips=False,
        gen_params=jax.jit(jsg2.init_generator_params, static_argnums=1)(jax.random.PRNGKey(5), mcfg_j))
    imgs, _, _, bits, alpha = jpl.generate_fingerprinted(jp, jax.random.PRNGKey(1), S_)
    a0 = lhs_alpha_init_batch(jax.random.PRNGKey(2), S_, N_, jp.basis.sigma_rest)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    port = dict(gen_params=rosinality.params_from_jax(jp.gen_params, "cpu"), basis=_basis_from_jax(jp.basis),
                noise=[t(n) for n in jp.noise], mcfg=ModelConfig(**MKW))
    return dict(jp=jp, mcfg_j=mcfg_j, imgs=imgs, bits=bits, alpha=alpha, a0=a0, port=port, t=t)


def _steps_agree(pr, acfg_kw, attack_kw, sigmas, loss_rtol=1e-4, grad_tol=1e-4, kink_steps=0, kink_tol=0.0):
    """Run the JAX step from its own state; at every step the port's loss and
    gradient (from that state) agree with JAX's.  Up to ``kink_steps`` steps may
    miss ``grad_tol`` (of the gradient's scale) and must then meet ``kink_tol``."""
    jp, t, port = pr["jp"], pr["t"], pr["port"]
    acfg_j = JAttributionConfig(steps=len(sigmas), n_starts=N_, loss="mse", **acfg_kw)
    acfg = AttributionConfig(steps=len(sigmas), n_starts=N_, loss="mse", **acfg_kw)
    opt = jattr._make_optimizer(acfg_j)
    jstep = jax.jit(jattr.make_attribution_step(
        jp.gen_params, None, jp.basis, jp.noise, pr["mcfg_j"], acfg_j, None, pr["imgs"][:, None], opt,
        attack_cfg=JAttackConfig(**attack_kw) if attack_kw else None))
    _, per_elem = attr.make_attribution_step(
        port["gen_params"], None, port["basis"], port["noise"], port["mcfg"], acfg, None,
        t(pr["imgs"])[:, None], AttackConfig(**attack_kw) if attack_kw else None)
    params = {"alpha": pr["a0"], "key": jnp.zeros((S_, N_, FKW["key_len"]))}
    opt_state = opt.init(params)
    off_steps = set()
    for i, sigma in enumerate(sigmas):
        mu = opt_state[0].mu
        alpha = t(params["alpha"]).requires_grad_(True)
        key = t(params["key"]).requires_grad_(True)
        per = per_elem(alpha, key, sigma if acfg.coarse_to_fine else None)
        grads = torch.autograd.grad(per.sum(), [alpha, key])
        (params, opt_state), jper = jstep((params, opt_state), jnp.float32(sigma))
        np.testing.assert_allclose(per.detach().numpy(), np.asarray(jper), rtol=loss_rtol, err_msg=f"step {i}")
        for name, g in zip(("alpha", "key"), grads):
            want = (np.asarray(opt_state[0].mu[name], np.float64)
                    - attr.B1 * np.asarray(mu[name], np.float64)) / (1.0 - attr.B1)
            err = np.abs(g.numpy() - want).max() / np.abs(want).max()
            if err > grad_tol:
                off_steps.add(i)
            assert err <= max(grad_tol, kink_tol), f"step {i} {name}: {err:.2e}"
    assert len(off_steps) <= kink_steps, f"gradients beyond {grad_tol} of their scale at steps {sorted(off_steps)}"


@pytest.mark.parametrize("name", ["Blur", "Jpeg", "Crop"])
def test_attack_aware_step_matches_jax(direct_cpu_convs, mse_problem, name):
    """The estimate goes through the attack's channel model before the loss:
    three steps, loss to 1e-4 relative and gradients to 1e-4 of their scale.

    Jpeg has kinks that Blur and Crop lack: the clamp to [0, 255] passes or
    blocks a pixel's cotangent, and a pixel within float32 rounding of the
    boundary falls on either side by summation order.  One of its three steps
    may miss 1e-4 for that (measured: step 2, 2.4e-3 of the scale) and is held
    to 5e-3; the loss agrees to 1e-4 at every step."""
    kink = dict(kink_steps=1, kink_tol=5e-3) if name == "Jpeg" else {}
    _steps_agree(mse_problem, dict(solver_attack=name), dict(augmentation=name, blur_sigma=1.0), [0.0] * 3,
                 **kink)


def test_coarse_to_fine_sigmas_blur_and_step_match_jax(direct_cpu_convs, mse_problem):
    acfg = AttributionConfig(steps=10, loss="mse", coarse_to_fine=True, ctf_sigma0=2.0, ctf_frac=0.5)
    anneal = max(1, int(acfg.ctf_frac * 10))
    want = acfg.ctf_sigma0 * jnp.maximum(0.0, 1.0 - jnp.arange(10, dtype=jnp.float32) / anneal)
    np.testing.assert_allclose(attr.ctf_sigmas(acfg, 10), np.asarray(want), atol=1e-6)
    assert attr.ctf_sigmas(AttributionConfig(steps=3), 3) == [None] * 3
    with pytest.raises(ValueError, match="requires --loss mse"):
        attr.ctf_sigmas(AttributionConfig(loss="perceptual", coarse_to_fine=True), 3)
    x = np.random.default_rng(0).standard_normal((2, 3, 12, 10, 3)).astype(np.float32)
    for sigma in (2.0, 0.7, 0.0):  # at 0 the floored kernel is the identity tap
        got = attr.ctf_blur(torch.from_numpy(x), sigma).numpy()
        np.testing.assert_allclose(got, np.asarray(jattr._ctf_blur(jnp.asarray(x), jnp.float32(sigma))), atol=1e-6)
    np.testing.assert_array_equal(got, x)
    # blurred steps on the way down the anneal, the last one unblurred
    _steps_agree(mse_problem, dict(coarse_to_fine=True), None, [2.0, 1.0, 0.0])


def test_executed_chain_steps_matches_jax_over_a_grid():
    for steps in (1, 2, 3, 20, 2000):
        for n in (1, 4, 20):
            for k in (0, 1, 2, 4, 20, 30):
                for frac in (0.0, 0.25, 0.5, 0.99, 1.0):
                    assert attr.executed_chain_steps(steps, n, k, frac) == jattr.executed_chain_steps(steps, n, k, frac)
                    if steps >= 2:
                        assert attr.prune_warm_steps(steps, frac) == jattr.prune_warm_steps(steps, frac)


def test_pruned_polished_solve_matches_jax(direct_cpu_convs, mse_problem):
    """Successive halving + one polish sweep, 6 steps from the same starts: the
    same survivors (their losses, in order), the same ORIGINAL restart index
    for the winner, the same key bits.  The solves run free for 6 steps at
    rate 0.2 and float32 solves drift apart through Adam (measured here:
    1.6e-3 relative on one restart's loss), so losses are held to 5e-3 relative."""
    pr, port = mse_problem, mse_problem["port"]
    kw = dict(steps=6, n_starts=N_, loss="mse", prune_starts=2, prune_frac=0.34, polish_sweeps=1)
    jres = jattr.attribute(pr["jp"].gen_params, None, pr["jp"].basis, pr["jp"].noise, pr["imgs"],
                           jax.random.PRNGKey(0), mcfg=pr["mcfg_j"], acfg=JAttributionConfig(**kw),
                           alpha_init=pr["a0"])
    res = attr.attribute(port["gen_params"], None, port["basis"], port["noise"], pr["t"](pr["imgs"]),
                         mcfg=port["mcfg"], acfg=AttributionConfig(**kw), alpha_init=pr["t"](pr["a0"]))
    assert res.losses_all.shape == (S_, 2)
    np.testing.assert_allclose(res.losses_all.numpy(), np.asarray(jres.losses_all), rtol=5e-3)
    np.testing.assert_array_equal(res.best_start.numpy(), np.asarray(jres.best_start))
    np.testing.assert_array_equal(res.key_bits.numpy(), np.asarray(jres.key_bits))
    np.testing.assert_allclose(res.loss.numpy(), np.asarray(jres.loss), rtol=5e-3)
    np.testing.assert_allclose(res.alpha.numpy(), np.asarray(jres.alpha), atol=5e-3)


def test_pruning_gathers_survivors_with_their_adam_moments(mse_problem):
    """Against the solve walked by hand with the port's own step: warm phase,
    stable argsort of its last pre-update loss, every per-restart tensor
    gathered (count kept), the rest of the schedule on the survivors."""
    pr, port = mse_problem, mse_problem["port"]
    acfg = AttributionConfig(steps=5, n_starts=N_, loss="mse", prune_starts=2, prune_frac=0.4)
    tgt, a0 = pr["t"](pr["imgs"]), pr["t"](pr["a0"])
    step, _ = attr.make_attribution_step(port["gen_params"], None, port["basis"], port["noise"],
                                         port["mcfg"], acfg, None, tgt[:, None])
    state = attr.init_state(a0, torch.zeros(S_, N_, FKW["key_len"]))
    warm = attr.prune_warm_steps(5, 0.4)
    assert warm == 2
    for _ in range(warm):
        state, per = step(state)
    order = np.argsort(per.numpy(), axis=1, kind="stable")[:, :2]
    kept = attr.gather_restarts(state, torch.from_numpy(order))
    assert kept["count"] == warm
    for name in ("alpha", "key", "m_alpha", "v_alpha", "m_key", "v_key"):
        for s in range(S_):
            np.testing.assert_array_equal(kept[name][s].numpy(), state[name][s].numpy()[order[s]])
    for _ in range(5 - warm):
        kept, per = step(kept)
    res = attr.attribute(port["gen_params"], None, port["basis"], port["noise"], tgt, mcfg=port["mcfg"],
                         acfg=acfg, alpha_init=a0)
    np.testing.assert_array_equal(res.losses_all.numpy(), per.numpy())
    np.testing.assert_array_equal(res.best_start.numpy(), order[np.arange(S_), per.numpy().argmin(1)])
    # ties keep the lower index, as jnp.argsort does
    tie = torch.tensor([[0.5, 0.1, 0.1, 0.5]])
    assert torch.argsort(tie, dim=1, stable=True)[:, :3].tolist() == [[1, 2, 0]]
    assert np.asarray(jnp.argsort(jnp.asarray(tie.numpy()), axis=1))[:, :3].tolist() == [[1, 2, 0]]


def test_polish_flips_back_the_one_wrong_bit(mse_problem):
    """True alpha, confident true key logits with bit 3 of sample 0 and bit 6 of
    sample 1 negated: two sweeps restore the true key (a greedy first sweep may
    flip a weak bit that a later flip makes wrong again: sample 1's bit 0 here);
    the JAX loop accepts the same flips, sweep by sweep, and lands on the same loss."""
    pr, port = mse_problem, mse_problem["port"]
    bits, alpha = np.asarray(pr["bits"]), np.asarray(pr["alpha"])
    logits = (2.0 * bits - 1.0) * 4.0
    wrong = logits.copy()
    wrong[0, 3] *= -1.0
    wrong[1, 6] *= -1.0
    acfg = AttributionConfig(loss="mse", n_starts=N_)
    got, loss = attr.polish_key_bits(port["gen_params"], None, port["basis"], port["noise"], pr["t"](pr["imgs"]),
                                     torch.from_numpy(alpha.copy()), torch.from_numpy(wrong.astype(np.float32)),
                                     mcfg=port["mcfg"], acfg=acfg, sweeps=2)
    np.testing.assert_array_equal(got.numpy(), logits.astype(np.float32))
    jgot, jloss = jattr.polish_key_bits(pr["jp"].gen_params, None, pr["jp"].basis, pr["jp"].noise, pr["imgs"],
                                        jnp.asarray(alpha), jnp.asarray(wrong, jnp.float32),
                                        mcfg=pr["mcfg_j"], acfg=JAttributionConfig(loss="mse", n_starts=N_), sweeps=2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jgot))
    one_t = attr.polish_key_bits(port["gen_params"], None, port["basis"], port["noise"], pr["t"](pr["imgs"]),
                                 torch.from_numpy(alpha.copy()), torch.from_numpy(wrong.astype(np.float32)),
                                 mcfg=port["mcfg"], acfg=acfg, sweeps=1)[0]
    one_j = jattr.polish_key_bits(pr["jp"].gen_params, None, pr["jp"].basis, pr["jp"].noise, pr["imgs"],
                                  jnp.asarray(alpha), jnp.asarray(wrong, jnp.float32), mcfg=pr["mcfg_j"],
                                  acfg=JAttributionConfig(loss="mse", n_starts=N_), sweeps=1)[0]
    np.testing.assert_array_equal(one_t.numpy(), np.asarray(one_j))
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), rtol=1e-3, atol=1e-7)
    # a margin no flip can clear leaves the logits as they were
    kept, _ = attr._polish_loop(lambda a, k: (k ** 2).sum(-1) * 0 + 1.0, torch.zeros(2, 3), torch.ones(2, 4), 2)
    assert torch.equal(kept, torch.ones(2, 4))


def test_chunked_restarts_equal_unchunked_given_the_same_starts(mse_problem):
    pr, port = mse_problem, mse_problem["port"]
    tgt, a0 = pr["t"](pr["imgs"]), pr["t"](pr["a0"])
    for kw in (dict(), dict(prune_starts=1, prune_frac=0.5)):
        acfg = AttributionConfig(steps=4, n_starts=N_, loss="mse", **kw)
        solve = lambda **k: attr.attribute_chunked(  # noqa: E731
            port["gen_params"], None, port["basis"], port["noise"], tgt, mcfg=port["mcfg"], acfg=acfg,
            alpha_init=a0, **k)
        whole, parts = solve(), solve(chunk_starts=2)
        assert parts.key_logits_all.shape == (S_, N_ if not kw else 2, FKW["key_len"])
        if not kw:
            np.testing.assert_array_equal(parts.key_logits_all.numpy(), whole.key_logits_all.numpy())
            np.testing.assert_array_equal(parts.best_start.numpy(), whole.best_start.numpy())
            np.testing.assert_allclose(parts.losses_all.numpy(), whole.losses_all.numpy(), rtol=1e-5)
            np.testing.assert_array_equal(parts.key_bits.numpy(), whole.key_bits.numpy())
            np.testing.assert_allclose(parts.loss.numpy(), whole.loss.numpy(), rtol=1e-5)
            np.testing.assert_allclose(parts.alpha.numpy(), whole.alpha.numpy(), atol=1e-5)
        else:  # pruning is per chunk: one survivor of each pair, reported by its index in the whole
            assert parts.losses_all.shape == (S_, 2)
            assert all(b in (0, 1, 2, 3) for b in parts.best_start.tolist())
            col = parts.losses_all.argmin(1)
            assert ((parts.best_start >= 2) == (col == 1)).all()
    # without given starts each chunk draws its own, from a generator folded with its offset
    acfg = AttributionConfig(steps=2, n_starts=N_, loss="mse")
    runs = [attr.attribute_chunked(port["gen_params"], None, port["basis"], port["noise"], tgt,
                                   mcfg=port["mcfg"], acfg=acfg, chunk_starts=2,
                                   generator=torch.Generator().manual_seed(seed)) for seed in (5, 5, 6)]
    assert torch.equal(runs[0].losses_all, runs[1].losses_all)
    assert not torch.equal(runs[0].losses_all, runs[2].losses_all)
    assert not torch.equal(runs[0].losses_all[:, :2], runs[0].losses_all[:, 2:])
