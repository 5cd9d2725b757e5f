"""The port's attribution solve vs the JAX package on the CPU, plus its
end-to-end checks: planted-key recovery, the CLI's output layout, and that
the port never imports JAX.
"""

import dataclasses
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


def test_perceptual_solve_matches_jax_loss_for_loss(direct_cpu_convs):
    """Same generator, LPIPS, basis, noise, targets and LHS starts; 10
    perceptual steps of the JAX solver.  At every step, from the JAX
    solver's state: the port's loss of every restart agrees to 1e-4
    relative; the port's Adam update, given the JAX gradient, lands on the
    JAX solver's next state (1e-5); and the port's gradient agrees with the
    JAX one to 1e-4 of its scale at all but at most one step.

    The one step allowed is a ReLU kink, not a port error: at step 3 of this
    solve one conv1_2 pre-activation of the 6 restarts' images is 2.8e-7
    from zero, and float32 rounding puts it on the other side in the port
    than in the JAX package and in a float64 evaluation.  Steps are compared
    from the same state because free-running float32 solves drift apart
    through Adam (its first moment cancels when a gradient changes sign)."""
    mcfg_j, steps = JModelConfig(**MKW), 10
    # weights made by jitted initializers: op-by-op JAX would compile each op
    jp = jpl.build_pipeline(
        jax.random.PRNGKey(0), mcfg_j, JFingerprintConfig(**FKW),
        gen_params=jax.jit(jsg2.init_generator_params, static_argnums=1)(jax.random.PRNGKey(5), mcfg_j),
        lpips_params=jax.jit(jlp.init_lpips_params)(jax.random.PRNGKey(6)),
    )
    imgs, _, _, _, _ = jpl.generate_fingerprinted(jp, jax.random.PRNGKey(1), 2)
    a0 = lhs_alpha_init_batch(jax.random.PRNGKey(2), 2, 3, jp.basis.sigma_rest)
    acfg_j = JAttributionConfig(steps=steps, n_starts=3, loss="perceptual")
    opt = jattr._make_optimizer(acfg_j)
    target_feats = tuple(f[:, None] for f in jax.jit(jlp.extract_features)(jp.lpips_params, imgs))
    jstep = jax.jit(jattr.make_attribution_step(
        jp.gen_params, jp.lpips_params, jp.basis, jp.noise, mcfg_j, acfg_j, target_feats, None, opt))

    acfg = AttributionConfig(steps=steps, n_starts=3, loss="perceptual")
    tl = lpips.params_from_jax(jp.lpips_params)
    with torch.no_grad():
        tfeats = [f[:, None] for f in lpips.extract_features(tl, torch.from_numpy(np.array(imgs)))]
    _, tper_elem = attr.make_attribution_step(
        rosinality.params_from_jax(jp.gen_params), tl, _basis_from_jax(jp.basis),
        [torch.from_numpy(np.array(n)) for n in jp.noise], ModelConfig(**MKW), acfg, tfeats, None)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    params = {"alpha": a0, "key": jnp.zeros((2, 3, 8))}
    opt_state = opt.init(params)
    off_steps = set()
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
        for name, g in (("alpha", g_alpha), ("key", g_key)):
            want = np.asarray(jg[name])
            if np.abs(g.numpy() - want).max() > 1e-4 * np.abs(want).max():
                off_steps.add(i)
            np.testing.assert_allclose(new[name].numpy(), np.asarray(params[name]), atol=1e-5,
                                       err_msg=f"step {i} {name}")
        assert new["count"] == int(opt_state[0].count)
    assert len(off_steps) <= 1, f"gradients differ beyond 1e-4 of their scale at steps {sorted(off_steps)}"


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


def test_cli_refuses_unported_flags():
    for extra in (["--augmentation", "Jpeg"], ["--attack_aware"], ["--polish_sweeps", "1"],
                  ["--prune_starts", "2"], ["--coarse_to_fine"], ["--init", "encoder"],
                  ["--resume", "x"], ["--chunk_starts", "2"], ["--chunk_samples", "2"],
                  ["--model", "biggan"], ["--dtype", "bfloat16"]):
        with pytest.raises(SystemExit, match="not yet ported"):
            cli_attribute.run(["--device", "cpu", "--random_init"] + extra)


def test_port_never_imports_jax():
    code = (
        "import sys, torch\n"
        f"from {PORT}.config import ModelConfig, FingerprintConfig, AttributionConfig\n"
        f"from {PORT}.fingerprint import pipeline as pl, attribute as attr\n"
        f"from {PORT}.cli import attribute, generate\n"
        "m = ModelConfig(img_size=8, style_dim=16, n_mlp=1, channel_max=16)\n"
        "p = pl.build_pipeline(m, FingerprintConfig(key_len=4, shift=8, n_pca_samples=100), device='cpu')\n"
        "imgs = pl.generate_fingerprinted(p, 1, torch.Generator().manual_seed(0))[0]\n"
        "r = attr.attribute(p.gen_params, p.lpips_params, p.basis, p.noise, imgs, mcfg=m,\n"
        "                   acfg=AttributionConfig(steps=2, n_starts=2, loss='mse'))\n"
        "assert r.key_bits.shape == (1, 4)\n"
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
