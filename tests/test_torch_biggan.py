"""The port's BigGAN-deep family vs the JAX package on the CPU: the generator
(with and without attention, forward and z-gradient), the running-statistics
blend, the state-dict converter, truncated-noise PCA, the BigGAN pipeline and
the solve step by step.  Tiny configurations (the JAX package's own tests');
every array both packages see is the same numpy array.
"""

import dataclasses

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
    embed as jembed,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.fingerprint import (
    pca as jpca,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.fingerprint import (
    pipeline as jpl,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.models import biggan as jbg
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.config import (
    AttributionConfig,
    FingerprintConfig,
    ModelConfig,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.fingerprint import (
    attribute as attr,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.fingerprint import (
    pca,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.fingerprint import (
    pipeline as pl,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.models import biggan as bg

# tests/test_biggan.py's SMALL (attention before layer 2) and tests/test_biggan_pipeline.py's SMALL_BG
CONFIGS = {
    "attention": dict(z_dim=16, class_embed_dim=16, channel_width=8, num_classes=10, output_dim=16,
                      attention_layer_position=2, layers=((False, 16, 16), (True, 16, 8), (True, 8, 4)), n_stats=5),
    "no_attention": dict(z_dim=16, class_embed_dim=8, channel_width=8, num_classes=10, output_dim=16,
                         attention_layer_position=99, layers=((False, 16, 16), (True, 16, 8), (True, 8, 4)),
                         n_stats=3),
}


def to_jax_layout(p):
    """The port's BigGAN tree -> the JAX package's layout (numpy): the inverse
    of ``params_from_jax``."""
    def arr(t):
        return t.numpy()

    def layer(q, conv):
        w = arr(q["w"])
        return {"w": w.transpose(2, 3, 1, 0) if conv else w.T, **({"b": arr(q["b"])} if "b" in q else {})}

    def bn(q):
        return {k: arr(v).T if k in ("scale_w", "offset_w") else arr(v) for k, v in q.items()}

    out = {
        "embeddings": arr(p["embeddings"]).T,
        "gen_z": layer(p["gen_z"], conv=False),
        "layers": tuple({k: bn(v) if k.startswith("bn") else layer(v, conv=True) for k, v in lay.items()}
                        for lay in p["layers"]),
        "bn_out": bn(p["bn_out"]),
        "conv_out": layer(p["conv_out"], conv=True),
    }
    if "attn" in p:
        out["attn"] = {**{k: layer(p["attn"][k], conv=True) for k in ("theta", "phi", "g", "o_conv")},
                       "gamma": arr(p["attn"]["gamma"])}
    return out


def make_params(cfg: bg.BigGANConfig, seed: int = 0):
    """Random port weights with running statistics that differ per truncation
    slot and a non-zero attention gamma (random init leaves both trivial), and
    the same weights in the JAX layout."""
    p = bg.init_biggan_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    g = torch.Generator().manual_seed(seed + 1)
    for bn in [lay[f"bn{j}"] for lay in p["layers"] for j in range(4)] + [p["bn_out"]]:
        bn["running_means"] = torch.randn(bn["running_means"].shape, generator=g) * 0.2
        bn["running_vars"] = 0.5 + torch.rand(bn["running_vars"].shape, generator=g)
    p["attn"]["gamma"] = torch.tensor(0.7)
    return p, jax.tree.map(jnp.asarray, to_jax_layout(p))


@pytest.mark.parametrize("name,truncation", [("attention", 0.3125), ("no_attention", 0.5)])
def test_forward_and_z_gradient_match_jax(name, truncation):
    """The image to 1e-5 absolute (with attention at a truncation between the
    statistics' grid points, without it on one); the gradient of
    <image, cotangent> with respect to z to 1e-4 of its scale."""
    cfg, jcfg = bg.BigGANConfig(**CONFIGS[name]), jbg.BigGANConfig(**CONFIGS[name])
    p, jp = make_params(cfg)
    rng = np.random.default_rng(1)
    z = (rng.standard_normal((3, cfg.z_dim)) * 0.4).astype(np.float32)
    onehot = bg.one_hot_from_int(3, cfg.num_classes, 3)
    cot = rng.standard_normal((3, 16, 16, 3)).astype(np.float32)

    def jloss(zz, tr):
        img = jbg.generate(jp, zz, jnp.asarray(onehot), tr, jcfg)
        return jnp.sum(img * cot), img

    (_, want), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True), static_argnums=1)(jnp.asarray(z), truncation)
    zt = torch.from_numpy(z).requires_grad_(True)
    img = bg.generate(p, zt, torch.from_numpy(onehot), truncation, cfg)
    (g,) = torch.autograd.grad((img * torch.from_numpy(cot)).sum(), zt)
    assert img.shape == (3, 16, 16, 3)
    np.testing.assert_allclose(img.detach().numpy(), np.asarray(want), atol=1e-5)
    jg = np.asarray(jg)
    assert np.abs(g.numpy() - jg).max() <= 1e-4 * np.abs(jg).max()


def test_interp_stats_matches_jax_exactly():
    """On the grid and between grid points, the package's inverted blend
    included (pos 1.25 -> 1 * 0.25 + 2 * 0.75 = 1.75)."""
    stats = np.stack([np.full(3, i, np.float32) for i in range(5)])
    rand = np.random.default_rng(2).standard_normal((51, 7)).astype(np.float32)
    for s, n in ((stats, 5), (rand, 51)):
        for tr in (0.0, 0.25, 0.3125, 0.375, 0.4, 0.5, 0.77, 1.0):
            got = bg._interp_stats(torch.from_numpy(s), tr, n).numpy()
            np.testing.assert_array_equal(got, np.asarray(jbg._interp_stats(jnp.asarray(s), tr, n)))
    assert bg._interp_stats(torch.from_numpy(stats), 0.3125, 5).tolist() == [1.75] * 3


def _synthetic_state_dict():
    """tests/test_biggan.py's synthetic spectral-norm state dict of a one-layer generator."""
    cfg = dict(z_dim=4, class_embed_dim=4, channel_width=4, num_classes=6, output_dim=8,
               attention_layer_position=99, layers=((True, 16, 16),), n_stats=3)
    rng = np.random.default_rng(0)
    ch, cond = 4, 8
    sd = {}

    def sn(prefix, shape, bias=True):
        sd[f"{prefix}.weight_orig"] = rng.standard_normal(shape).astype(np.float32)
        sd[f"{prefix}.weight_u"] = rng.standard_normal(shape[0]).astype(np.float32)
        if bias:
            sd[f"{prefix}.bias"] = rng.standard_normal(shape[0]).astype(np.float32)

    def bn(prefix, c, conditional=True):
        sd[f"{prefix}.running_means"] = rng.standard_normal((3, c)).astype(np.float32)
        sd[f"{prefix}.running_vars"] = np.abs(rng.standard_normal((3, c))).astype(np.float32) + 0.5
        if conditional:
            sn(f"{prefix}.scale", (c, cond), bias=False)
            sn(f"{prefix}.offset", (c, cond), bias=False)
        else:
            sd[f"{prefix}.weight"] = np.ones(c, np.float32)
            sd[f"{prefix}.bias"] = np.zeros(c, np.float32)

    sn("embeddings", (4, 6), bias=False)
    sn("generator.gen_z", (4 * 4 * 16 * ch, cond))
    c, mid = 16 * ch, 4 * ch
    for j, (ci, co, k) in enumerate(((c, mid, 1), (mid, mid, 3), (mid, mid, 3), (mid, c, 1))):
        bn(f"generator.layers.0.bn_{j}", ci)
        sn(f"generator.layers.0.conv_{j}", (co, ci, k, k))
    bn("generator.bn", c, conditional=False)
    sn("generator.conv_to_rgb", (c, c, 3, 3))
    return cfg, sd


def test_state_dict_converter_matches_jax():
    """Spectral norm folded, the RGB slice cut, the same effective weights as the
    JAX converter's (moved across by ``params_from_jax``), the same image."""
    cfg_kw, sd = _synthetic_state_dict()
    cfg, jcfg = bg.BigGANConfig(**cfg_kw), jbg.BigGANConfig(**cfg_kw)
    got = bg.params_from_torch_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, cfg, device="cpu")
    jparams = jbg.params_from_torch_state_dict(sd, jcfg)
    want = bg.params_from_jax(jparams, "cpu")
    flat_got, flat_want = jax.tree_util.tree_flatten_with_path(got)[0], jax.tree_util.tree_flatten_with_path(want)[0]
    assert [k for k, _ in flat_got] == [k for k, _ in flat_want]
    for (path, a), (_, b) in zip(flat_got, flat_want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=0, msg=str(path))
    assert got["conv_out"]["w"].shape == (3, 64, 3, 3)
    # the converters' round trip through the JAX layout is exact
    for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(to_jax_layout(got))[0],
                                 jax.tree_util.tree_flatten_with_path(jparams)[0]):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, err_msg=str(path))
    z = np.random.default_rng(6).standard_normal((1, 4)).astype(np.float32) * 0.4
    onehot = bg.one_hot_from_int(2, 6, 1)
    img = bg.generate(got, torch.from_numpy(z), torch.from_numpy(onehot), 0.4, cfg)
    jimg = jax.jit(jbg.generate, static_argnums=(3, 4))(jax.tree.map(jnp.asarray, jparams), jnp.asarray(z),
                                                       jnp.asarray(onehot), 0.4, jcfg)
    assert img.shape == (1, 8, 8, 3)
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), atol=1e-5)


def test_truncated_noise_one_hot_and_pca_match_jax():
    z = bg.truncated_noise(2000, 0.4, 16, torch.Generator().manual_seed(2)).numpy()
    assert z.shape == (2000, 16) and np.abs(z).max() <= 0.8 + 1e-6 and 0.34 < z.std() < 0.36
    oh = bg.one_hot_from_name("golden retriever", batch_size=2)
    np.testing.assert_array_equal(oh, jbg.one_hot_from_name("golden retriever", batch_size=2))
    np.testing.assert_array_equal(bg.one_hot_from_name("7", 10), jbg.one_hot_from_name("7", 10))
    with pytest.raises(ValueError, match="unknown label"):
        bg.one_hot_from_name("definitely not a class")
    with pytest.raises(ValueError, match="out of range"):
        bg.one_hot_from_int(10, 10)
    # PCA of given truncated noise: the JAX package's own draw, passed to the port
    key = jax.random.PRNGKey(3)
    jb, drawn = jax.jit(lambda k: (jpca.pca_from_truncated_noise(k, 0.4, 1500, 16),
                                   jax.random.truncated_normal(k, -2.0, 2.0, (1500, 16)) * 0.4))(key)
    drawn = np.asarray(drawn)
    tb = pca.pca_from_truncated_noise(0.4, 1500, 16, device="cpu", z=torch.from_numpy(drawn.copy()))
    np.testing.assert_allclose(tb.mean.numpy(), np.asarray(jb.mean), atol=1e-6)
    np.testing.assert_allclose(tb.sigma.numpy(), np.asarray(jb.sigma), rtol=1e-4)
    np.testing.assert_allclose(np.abs(tb.pc.numpy() @ np.asarray(jb.pc).T), np.eye(16), atol=2e-3)


MCFG_KW = dict(model="biggan", img_size=16, biggan_label="3")
FKW = dict(key_len=4, shift=12, sigma=0.2, n_pca_samples=500)


@pytest.fixture(scope="module")
def bg_problem():
    """The JAX package's BigGAN pipeline (tests/test_biggan_pipeline.py's) on the
    port's weights, and the port's pipeline from the same weights and the JAX
    pipeline's own PCA draw; two fingerprinted targets (JAX's images of given
    alpha and bits) and two starts each."""
    cfg_kw = CONFIGS["no_attention"]
    p, jparams = make_params(bg.BigGANConfig(**cfg_kw), seed=4)
    key = jax.random.PRNGKey(0)
    jp = jpl.build_pipeline(key, JModelConfig(**MCFG_KW), JFingerprintConfig(**FKW), want_lpips=False,
                            gen_params=jparams, biggan_cfg=jbg.BigGANConfig(**cfg_kw), truncation=0.4)
    k_pca = jax.random.split(key, 4)[1]  # build_pipeline's PCA key
    pca_z = np.asarray(jax.random.truncated_normal(k_pca, -2.0, 2.0, (FKW["n_pca_samples"], 16)) * 0.4)
    tp = pl.build_pipeline(ModelConfig(**MCFG_KW), FingerprintConfig(**FKW), device="cpu", want_lpips=False,
                           gen_params=p, pca_z=torch.from_numpy(pca_z.copy()), biggan_cfg=bg.BigGANConfig(**cfg_kw))
    rng = np.random.default_rng(5)
    sigma = np.asarray(jp.basis.sigma_rest)
    alpha = (rng.standard_normal((2, 12)) * sigma).astype(np.float32)
    bits = rng.integers(0, 2, (2, 4)).astype(np.float32)
    _, wx = jembed.embed(jp.basis, jnp.asarray(alpha), jnp.asarray(bits))
    imgs = jax.jit(jbg.generate, static_argnums=(3, 4))(jp.gen_params, wx, jnp.broadcast_to(jp.class_onehot, (2, 10)),
                                                        jp.truncation, jp.biggan_cfg)
    a0 = ((2.0 * rng.random((2, 2, 12)) - 1.0) * sigma).astype(np.float32)
    return jp, tp, np.asarray(imgs), bits, alpha, a0


def test_biggan_pipeline_matches_jax(bg_problem):
    """Basis, class one-hot, no noise; the fingerprinted images of given draws."""
    jp, tp, imgs, bits, alpha, _ = bg_problem
    assert tp.noise == [] and tp.truncation == 0.4 and tp.biggan_cfg.z_dim == 16
    assert tp.class_onehot.shape == (1, 10) and float(tp.class_onehot[0, 3]) == 1.0
    for f in ("u_cap", "v_cap", "sigma_rest", "mean"):
        np.testing.assert_allclose(getattr(tp.basis, f).numpy(), np.asarray(getattr(jp.basis, f)), atol=2e-5,
                                   err_msg=f)
    got, _, wx, _, _ = pl.generate_fingerprinted(tp, alpha=torch.from_numpy(alpha), bits=torch.from_numpy(bits))
    np.testing.assert_allclose(got.numpy(), imgs, atol=1e-5)
    np.testing.assert_allclose(pl.synthesize(tp, wx).numpy(), got.numpy(), atol=0)
    with pytest.raises(ValueError, match="img_size"):
        pl.build_pipeline(ModelConfig(**dict(MCFG_KW, img_size=32)), FingerprintConfig(**FKW), device="cpu",
                          want_lpips=False, biggan_cfg=tp.biggan_cfg)


def test_biggan_solve_matches_jax_step_by_step(bg_problem):
    """Three mse steps of the JAX solver from its own state; at each the port's
    loss of every restart from that state to 1e-4 relative, and its gradient to
    1e-4 of the gradient's scale at all but at most one step, held there to
    1e-2.  That step is a ReLU kink, not a port error: at step 1 of this solve
    one restart's float32 gradient in the port is 5.7e-3 (alpha) and 8.7e-3
    (key) of the scale from JAX's, while the port evaluated in float64 at the
    same state agrees with JAX to 2.5e-6; steps 0 and 2 agree to ~1e-5.  Then
    the port's whole solve runs from the same starts; its key logits of every
    restart hold the winner's."""
    jp, tp, imgs, _, _, a0 = bg_problem
    steps = 3
    acfg_j = JAttributionConfig(steps=steps, n_starts=2, loss="mse", lr=0.1)
    opt = jattr._make_optimizer(acfg_j)
    jstep = jax.jit(jattr.make_attribution_step(
        jp.gen_params, None, jp.basis, jp.noise, jp.mcfg, acfg_j, None, jnp.asarray(imgs)[:, None], opt,
        biggan_cfg=jp.biggan_cfg, class_onehot=jp.class_onehot, truncation=jp.truncation))
    acfg = AttributionConfig(steps=steps, n_starts=2, loss="mse", lr=0.1)
    _, per_elem = attr.make_attribution_step(tp.gen_params, None, tp.basis, tp.noise, tp.mcfg, acfg, None,
                                             torch.from_numpy(imgs)[:, None], **pl.solver_kwargs(tp))
    params = {"alpha": jnp.asarray(a0), "key": jnp.zeros((2, 2, 4))}
    opt_state = opt.init(params)
    off_steps = set()
    for i in range(steps):
        mu = opt_state[0].mu
        alpha = torch.from_numpy(np.array(params["alpha"])).requires_grad_(True)
        key = torch.from_numpy(np.array(params["key"])).requires_grad_(True)
        per = per_elem(alpha, key)
        grads = torch.autograd.grad(per.sum(), [alpha, key])
        (params, opt_state), jper = jstep((params, opt_state), 0.0)
        np.testing.assert_allclose(per.detach().numpy(), np.asarray(jper), rtol=1e-4, err_msg=f"step {i}")
        for name, g in zip(("alpha", "key"), grads):
            want = (np.asarray(opt_state[0].mu[name], np.float64)
                    - attr.B1 * np.asarray(mu[name], np.float64)) / (1.0 - attr.B1)
            err = np.abs(g.numpy() - want).max() / np.abs(want).max()
            if err > 1e-4:
                off_steps.add(i)
            assert err <= 1e-2, f"step {i} {name}: {err:.2e}"
    assert len(off_steps) <= 1, f"gradients beyond 1e-4 of their scale at steps {sorted(off_steps)}"
    res = attr.attribute(tp.gen_params, None, tp.basis, tp.noise, torch.from_numpy(imgs), mcfg=tp.mcfg, acfg=acfg,
                         alpha_init=torch.from_numpy(a0), **pl.solver_kwargs(tp))
    assert res.key_bits.shape == (2, 4) and res.key_logits_all.shape == (2, 2, 4)
    assert torch.equal(res.key_logits_all[torch.arange(2), res.best_start], res.key_logits)
    assert bool(torch.isfinite(res.loss).all())
    assert dataclasses.replace(tp.mcfg, model="biggan").style_space_dim == 128


def test_engine_serves_biggan(bg_problem):
    """The serving engine routes a BigGAN pipeline: a generated row is the
    pipeline's image of the row's latent, and an attribute batch solves with
    the pipeline's class and truncation."""
    from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.serving import (
        InferenceEngine,
        ServeConfig,
    )

    _, tp, imgs, _, _, _ = bg_problem
    eng = InferenceEngine(tp, acfg=AttributionConfig(steps=2, n_starts=2, loss="mse"), cfg=ServeConfig(buckets=(2,)))
    rows = [{"seed": 3, "bits": None}, {"seed": 4, "bits": np.ones(4, np.float32)}]
    got, wx, bits, _ = eng.run_bucket("generate", 2, rows)
    assert got.shape == (2, 16, 16, 3) and bits[1].tolist() == [1.0] * 4
    np.testing.assert_allclose(got, pl.synthesize(tp, torch.from_numpy(wx)).numpy(), atol=1e-6)
    key_bits, _, loss = eng.run_bucket("attribute", 2, [{"image": imgs[0]}, {"image": imgs[1]}])
    assert key_bits.shape == (2, 4) and np.isfinite(loss).all()
