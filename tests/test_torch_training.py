"""The port's StyleGAN2 training against the JAX package on the CPU.

The JAX training tests' tiny configuration (16px, style_dim 32, n_mlp 2,
channel_max 32, batch 4, d_reg_every 2), oneDNN's convolutions off as in the
solver's parity tests.  The train step is fed the JAX package's own draws
(its keys split as ``training/gan.py`` and ``_mixed_latent`` split them) and
the same weights, and the two steps agree in the losses and in the gradients
of both networks to 1e-4 of each leaf's scale (float32 sums in another order, through
the generator, three discriminator passes and R1's second derivative).
Adam with b1 = 0 makes its first moment the gradient, so that is where the
gradients are read.  The updated parameters are compared only where
|g| >= 1e-3 of the leaf's gradient scale: Adam's first update is about
lr * sign(g), and below that a gradient within the tolerance of zero may take
the other sign; there they (and the EMA) agree to 1e-6 absolute plus 1e-6
relative: a few float32 roundings of p -/+ lr, the mapping weights being ~100.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.checkpoints import (
    flat as jflat,
    rosinality as jros,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.config import (
    ModelConfig as JModelConfig,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.models import (
    stylegan2 as jsg2,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.training import (
    data as jdata,
    folder as jfolder,
    gan as jgan,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.checkpoints import (
    flat,
    rosinality,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.cli import train as cli_train
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.config import ModelConfig
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.models import (
    stylegan2 as sg2,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.training import (
    data,
    folder,
    gan,
    snapshot,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.utils.tree import (
    tree_leaves,
)

KW = dict(img_size=16, style_dim=32, n_mlp=2, channel_max=32)
JMCFG, MCFG = JModelConfig(**KW), ModelConfig(**KW)
TKW = dict(batch=4, d_reg_every=2, ema_decay=0.9)
JTCFG, TCFG = jgan.TrainConfig(**TKW), gan.TrainConfig(**TKW)
TOL = 1e-4
SMALL = ["--device", "cpu", "--img_size", "16", "--style_dim", "32", "--n_mlp", "2", "--channel_max", "32",
         "--batch", "4", "--d_reg_every", "2"]


@pytest.fixture
def direct_cpu_convs():
    before = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    yield
    torch.backends.mkldnn.enabled = before


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_draw_arrays(key):
    """The draws of the JAX step for ``key``, split as it splits them."""
    _, k_lat_d, k_noise_d, k_lat_g, k_noise_g = jax.random.split(key, 5)

    def phase(k_lat, k_noise):
        kz, kt, kp = jax.random.split(k_lat, 3)
        b = JTCFG.batch
        return (jax.random.normal(kz, (2, b, JMCFG.style_dim)), jax.random.randint(kt, (b,), 1, JMCFG.n_latent),
                jax.random.bernoulli(kp, JTCFG.mixing, (b,)), jsg2.make_noise(k_noise, JMCFG.img_size))

    return phase(k_lat_d, k_noise_d), phase(k_lat_g, k_noise_g)


def _port_draws(arrays, real):
    def phase(z, t, use_mix, noise):
        return gan.PhaseDraws(z=_t(z), t=_t(t).long(), use_mix=_t(use_mix), noise=[_t(n) for n in noise])

    d, g = arrays
    return {"real": _t(real), "d": phase(*d), "g": phase(*g)}


def _jax_first_step(g_params, d_params, key, real):
    """The JAX package's first step from these weights (its TrainState with
    fresh Adam states), and the draws it took: one program."""
    opt = jgan._optimizer(JTCFG)
    state = jgan.TrainState(step=jnp.zeros((), jnp.int32), g_params=g_params, d_params=d_params,
                            g_ema=g_params, g_opt=opt.init(g_params), d_opt=opt.init(d_params))
    new, metrics = jgan.make_train_step(JMCFG, JTCFG, external_data=True)(state, key, real)
    return new, metrics, _jax_draw_arrays(key)


def _close_trees(got, want, what, mask_from=None):
    got, want = flat.flatten_params(got), jflat.flatten_params(want)
    assert sorted(got) == sorted(want), what
    for name, w in want.items():
        w = np.asarray(w)
        if mask_from is None:
            np.testing.assert_allclose(got[name], w, atol=TOL * max(1.0, float(np.abs(w).max())),
                                       err_msg=f"{what} {name}")
        else:
            g = np.asarray(mask_from[name])
            keep = np.abs(g) >= 1e-3 * np.abs(g).max() if np.abs(g).max() > 0 else np.zeros(g.shape, bool)
            np.testing.assert_allclose(got[name][keep], w[keep], rtol=1e-6, atol=1e-6, err_msg=f"{what} {name}")


def test_train_step_matches_jax(direct_cpu_convs):
    """One step of the JAX step (external data) at step 0, so with R1, and the
    port's step from the same weights with the JAX draws."""
    state = gan.init_train_state(MCFG, TCFG, torch.Generator().manual_seed(0), "cpu")
    g, d = (jax.tree.map(lambda v: jnp.asarray(v.numpy()), t) for t in (state.g_params, state.d_params))
    key = jax.random.PRNGKey(100)
    real = np.random.default_rng(0).uniform(-1, 1, (4, 16, 16, 3)).astype(np.float32)
    # the least XLA optimization: a faster compile of the same arithmetic
    js, jm, draws = jax.jit(_jax_first_step, compiler_options={"xla_backend_optimization_level": 0})(
        g, d, key, jnp.asarray(real))
    state, m = gan.train_step(state, _port_draws(draws, real), MCFG, TCFG)
    for k in ("d_loss", "r1", "g_loss"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=TOL, err_msg=k)
    assert float(m["r1"]) > 0
    jd_grad, jg_grad = jax.tree.map(np.asarray, js.d_opt[0].mu), jax.tree.map(np.asarray, js.g_opt[0].mu)
    _close_trees(state.d_opt["mu"], jd_grad, "D gradient")
    _close_trees(state.g_opt["mu"], jg_grad, "G gradient")
    _close_trees(state.d_params, js.d_params, "D params", jflat.flatten_params(jd_grad))
    _close_trees(state.g_params, js.g_params, "G params", jflat.flatten_params(jg_grad))
    _close_trees(state.g_ema, js.g_ema, "EMA", jflat.flatten_params(jg_grad))
    assert state.step == int(js.step) == 1 and state.d_opt["count"] == int(js.d_opt[0].count) == 1


def test_port_training_r1_schedule_ema_and_bit_exact_resume(tmp_path):
    """The port alone: R1 at steps 0 and 2 only, the EMA between init and the
    current weights, and 2 steps + snapshot + reload + 2 steps equal to 4
    uninterrupted steps bit for bit; a snapshot of another config or a
    changed meta is refused."""
    def fresh():
        return gan.init_train_state(MCFG, TCFG, torch.Generator().manual_seed(0), "cpu")

    state = fresh()
    w0 = state.g_params["conv1"]["weight"].clone()
    rows = gan.run_steps(state, 7, 4, MCFG, TCFG)
    assert np.isfinite(np.concatenate(list(rows.values()))).all()
    assert (rows["r1"] > 0).tolist() == [True, False, True, False]
    moved = (state.g_params["conv1"]["weight"] - w0).abs().max()
    ema_moved = (state.g_ema["conv1"]["weight"] - w0).abs().max()
    assert 0 < ema_moved < moved

    half = fresh()
    gan.run_steps(half, 7, 2, MCFG, TCFG)
    path = str(tmp_path / "snap.npz")
    meta = {"seed": 7, "img_size": 16}
    snapshot.save_snapshot(path, half, {**meta, "step": half.step})
    resumed, got_meta = snapshot.load_snapshot(path, fresh())
    snapshot.check_meta(got_meta, meta)
    assert resumed.step == 2
    rows2 = gan.run_steps(resumed, 7, 2, MCFG, TCFG)
    np.testing.assert_array_equal(rows2["g_loss"], rows["g_loss"][2:])
    for a, b in zip(tree_leaves([state.g_params, state.d_params, state.g_ema, state.g_opt, state.d_opt]),
                    tree_leaves([resumed.g_params, resumed.d_params, resumed.g_ema, resumed.g_opt,
                                 resumed.d_opt])):
        assert (a == b).all() if isinstance(a, torch.Tensor) else a == b
    with pytest.raises(ValueError, match="refusing to resume"):
        snapshot.check_meta(got_meta, {**meta, "seed": 8})
    other = gan.init_train_state(ModelConfig(**{**KW, "channel_max": 16}), TCFG,
                                 torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="template expects"):
        snapshot.load_snapshot(path, other)
    with pytest.raises(ValueError, match="leaves"):
        snapshot.load_snapshot(path, gan.init_train_state(ModelConfig(**{**KW, "img_size": 32}), TCFG,
                                                          torch.Generator().manual_seed(0), "cpu"))


def test_train_step_launches_match_the_roofline_table(monkeypatch):
    """The FIR wrappers routed through their autograd Functions as on the card,
    with counting plain launches: a step with R1 and one without launch what
    ``ops/roofline.py::train_launches`` says (``chip_smoke.py`` asserts the same
    counts on the card at 256px)."""
    from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.ops import (
        roofline,
        upfirdn2d_cuda as U,
    )

    counts = {"blur4": 0, "upblur4": 0, "upblur4_adj": 0}

    def counted(name, fn):
        def launch(*a):  # opaque to autograd, as a kernel launch is
            counts[name] += 1
            with torch.no_grad():
                return fn(*a)
        return launch

    monkeypatch.setattr(U, "blur4_launch", counted(
        "blur4", lambda x, fy, fx, py, px: U.blur4_plain(x, fy[::-1], fx[::-1], py, px)))
    monkeypatch.setattr(U, "upblur4_launch", counted(
        "upblur4", lambda x, k, rgb=None: U.upblur4_plain(x, k) + (0 if rgb is None else rgb)))
    monkeypatch.setattr(U, "upblur4_adjoint_launch", counted("upblur4_adj", U.upblur4_adjoint_plain))
    monkeypatch.setattr(U, "blur4", lambda x, ky, kx, py, px: U._Blur4.apply(x, tuple(ky), tuple(kx), py, px))
    monkeypatch.setattr(U, "upblur4_add", lambda rgb, x, k: U._Upblur4.apply(x, rgb, tuple(k)))
    # synthesis's skip chain as on the card in float32: one fused upblur4 a level
    monkeypatch.setattr(U, "upblur4_chain", lambda ts, k: U.upblur4_chain_per_level(ts, tuple(k)))
    mcfg = ModelConfig(img_size=32, style_dim=16, n_mlp=1, channel_max=16)
    tcfg = gan.TrainConfig(batch=2, d_reg_every=2)
    state = gan.init_train_state(mcfg, tcfg, torch.Generator().manual_seed(0), "cpu")
    for r1 in (True, False):
        counts.update(blur4=0, upblur4=0, upblur4_adj=0)
        gan.run_steps(state, 0, 1, mcfg, tcfg)
        want = {k: v for k, v in roofline.train_launches(32, r1).items() if k in counts}
        assert counts == want, (r1, counts, want)


def test_exports_round_trip_through_both_packages(tmp_path):
    state = gan.init_train_state(MCFG, TCFG, torch.Generator().manual_seed(1), "cpu")
    path = str(tmp_path / "ema.npz")
    np.savez(path, **rosinality.generator_state_dict_from_params(state.g_ema))
    want = flat.flatten_params(state.g_ema)
    for got in (flat.flatten_params(rosinality.load_generator(path, MCFG, device="cpu")),
                jflat.flatten_params(jros.load_generator(path, JMCFG))):
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            np.testing.assert_array_equal(np.asarray(got[k]), v, err_msg=k)
    dpath = str(tmp_path / "d.disc.npz")
    np.savez(dpath, **flat.flatten_params(state.d_params))
    with np.load(dpath) as z:
        jtree = jflat.unflatten_params({k: z[k] for k in z.files})
    jd = jax.eval_shape(lambda k: jsg2.init_discriminator_params(k, JMCFG), jax.random.PRNGKey(2))
    assert jax.tree.structure(jtree) == jax.tree.structure(jd)
    back = flat.unflatten_params(jflat.flatten_params(jtree), "cpu")
    for a, b in zip(tree_leaves(back), tree_leaves(state.d_params)):
        assert (a == b).all()


def _jax_scene_factors(key, size):
    """The factors ``_scene`` draws for one image key, split as it splits them."""
    (kbg, kdir, kpos, kscale, kang, kcol, kamp, krect, kstripe) = jax.random.split(key, 9)
    u = jax.random.uniform
    c0, c1 = u(kbg, (2, 3), minval=-0.8, maxval=0.8)
    kr1, kr2, kr3, kr4 = jax.random.split(krect, 4)
    ks1, ks2, ks3, ks4 = jax.random.split(kstripe, 4)
    return dict(
        c0=c0, c1=c1, gdir=jax.random.normal(kdir, (2,)),
        pos=u(kpos, (3, 2), minval=-0.7, maxval=0.7), scale=u(kscale, (3, 2), minval=0.08, maxval=0.45),
        ang=u(kang, (3,), minval=0.0, maxval=jnp.pi), col=u(kcol, (3, 3), minval=-1.0, maxval=1.0),
        amp=u(kamp, (3,), minval=0.6, maxval=1.4),
        rpos=u(kr1, (2, 2), minval=-0.6, maxval=0.6), rhalf=u(kr2, (2, 2), minval=0.1, maxval=0.4),
        rang=u(kr3, (2,), minval=0.0, maxval=jnp.pi), rcol=u(kr4, (2, 3), minval=-1.0, maxval=1.0),
        spos=u(ks1, (2,), minval=-0.5, maxval=0.5), sang=u(ks2, (), minval=0.0, maxval=jnp.pi),
        freq=u(ks3, (), minval=4.0, maxval=10.0) * jnp.pi, scol=u(ks4, (3,), minval=-1.0, maxval=1.0))


def test_data_render_matches_jax_and_lowdim_is_rank_d():
    key, b, size, d = jax.random.PRNGKey(11), 3, 16, 3

    @jax.jit
    def jax_side(key):
        keys = jax.random.split(key, b)
        return (jax.vmap(lambda k: _jax_scene_factors(k, size))(keys),
                jdata.sample_batch(key, b, size, False), jdata.sample_batch(key, b, size, True),
                jax.vmap(lambda k: jdata._lowdim_factors(k, d))(keys), jdata.sample_batch(key, b, size, False, d))

    factors, smooth, sharp, z, lowdim = jax_side(key)
    f = {k: _t(v) for k, v in factors.items()}
    np.testing.assert_allclose(data.render(f, size).numpy(), np.asarray(smooth), atol=1e-6, err_msg="smooth")
    np.testing.assert_allclose(data.render(f, size, sharp=True).numpy(), np.asarray(sharp), atol=1e-6,
                               err_msg="sharp")
    got = data.render(data.smooth_factors_from_z(_t(z)), size).numpy()
    np.testing.assert_allclose(got, np.asarray(lowdim), atol=1e-6, err_msg="lowdim")

    # the port's own rank-limited draw: exactly rank d before the tanh
    zp = data.lowdim_factors(torch.Generator().manual_seed(0), 64, d).double().numpy()
    assert zp.shape == (64, data._FACTOR_DIM) and np.abs(zp).max() < 1.0
    s = np.linalg.svd(np.arctanh(zp), compute_uv=False)
    assert s[d - 1] > 1e-3 and s[d] < 1e-4 * s[0], s[: d + 2]
    imgs = data.sample_batch(torch.Generator().manual_seed(1), 4, 16, latent_dim=d, device="cpu")
    assert imgs.shape == (4, 16, 16, 3) and imgs.abs().max() <= 1.0
    with pytest.raises(ValueError):
        data.sample_batch(torch.Generator(), 2, 16, sharp=True, latent_dim=d, device="cpu")


def test_image_folder_schedule_and_batches_match_jax(tmp_path, monkeypatch):
    """Same files, same schedule as the JAX package's, same batches; without
    the native decoder the port decodes with PIL, within one uint8 step."""
    from PIL import Image

    from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.utils import native_io

    rng = np.random.default_rng(0)
    for i in range(5):
        sub = tmp_path / ("b" if i % 2 else "a")
        sub.mkdir(exist_ok=True)
        Image.fromarray(rng.integers(0, 256, (20 + i, 18, 3), dtype=np.uint8)).save(sub / f"{i}.png")
    ours, theirs = folder.ImageFolder(str(tmp_path), 8), jfolder.ImageFolder(str(tmp_path), 8)
    assert ours.files == theirs.files
    for start in (0, 3):
        for a, b in zip(ours.schedule(3, 4, 6, start=start), theirs.schedule(3, 4, 6, start=start)):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(ours.batches(3, 4, 3, start=1), theirs.batches(3, 4, 3, start=1)):
        np.testing.assert_array_equal(a, b)
    monkeypatch.setattr(native_io, "image_read_available", lambda: False)
    monkeypatch.setattr(native_io, "read_available", lambda: False)
    assert not ours.native_decode
    np.testing.assert_allclose(ours.load_batch([0, 3, 4]), theirs.load_batch([0, 3, 4]), atol=1.0 / 127.5 + 1e-6)


def test_cli_train_resume_and_metrics_continuity(tmp_path):
    """2 steps with a snapshot, then --resume to 4: one metrics row per step
    across both runs, and the export equal to an uninterrupted 4-step run."""
    snap, metrics = str(tmp_path / "snap.npz"), str(tmp_path / "m.jsonl")
    part = str(tmp_path / "part.npz")
    assert cli_train.main(SMALL + ["--steps", "2", "--chunk", "1", "--snapshot", snap,
                                   "--metrics_out", metrics, "--out", part]) == 0
    assert cli_train.main(SMALL + ["--steps", "4", "--chunk", "1", "--snapshot", snap, "--resume",
                                   "--metrics_out", metrics, "--out", part]) == 0
    whole = str(tmp_path / "whole.npz")
    assert cli_train.main(SMALL + ["--steps", "4", "--chunk", "2", "--out", whole]) == 0
    rows = [json.loads(line) for line in open(metrics)]
    assert [r["step"] for r in rows] == [1, 2, 3, 4]
    assert [r["r1"] > 0 for r in rows] == [True, False, True, False]
    with np.load(part) as a, np.load(whole) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert os.path.exists(part + ".disc.npz")
    img = sg2.generate(rosinality.load_generator(part, MCFG, device="cpu"), [torch.randn(2, 32)], MCFG)
    assert torch.isfinite(img).all()
    # data-parallel training is ported: outside a torchrun job the world is one rank, and a
    # 2-wide data axis is refused with the reference package's make_mesh error
    with pytest.raises(ValueError, match="mesh 2x1 needs 2 devices, have 1"):
        cli_train.main(SMALL + ["--mesh_data", "2"])
    if not torch.cuda.is_available():  # the default device is the card, with no fallback
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli_train.main(["--steps", "1", "--out", ""])
