"""The port's attacks and solver attacks vs the JAX package on the CPU.

The same numpy images (NHWC in [-1, 1], 32-64 px) go through the JAX function
and its counterpart in the port.  Random attacks are fed the noise that JAX
drew: the two frameworks' streams differ by construction.  Tolerances on
[-1, 1]: Blur, Crop, Noise 1e-5 (a 25-tap float32 sum in another order); Jpeg
with differentiable rounding 2e-4 (the chain runs on [0, 255], where float32
sums over 64 coefficients differ by ~1e-5, scaled by 2/255 and by the cubic's
slope); Jpeg with hard rounding: a coefficient within ~1e-5 of a half-integer
rounds the other way and moves its 8x8 block by a whole quantisation step, so
that test counts pixels (at least 99.9% within 2e-4) instead of taking a max.
Gradients of sum(attack(img)) through each solver attack: 1e-4 of their scale.
The train-mode attacks (``gaussian_blur_random``, ``random_crop``,
``make_attack(..., is_train=True)``) are fed the index or offset that JAX's
key drew, at every value the draw can take, within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu import attacks as jatk
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.config import (
    AttackConfig as JAttackConfig,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch import attacks as atk
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.config import AttackConfig

ATOL = 1e-5
JPEG_ATOL = 2e-4
NAMES = ["Noise", "Blur", "Jpeg", "Crop", "Combination"]


def _images(h, w, seed=0, b=2):
    """Smooth images with some texture, inside [-1, 1] with a few values clipped."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(-1, 1, h), np.linspace(-1, 1, w), indexing="ij")
    base = np.stack([np.sin(3 * xx + p) * np.cos(2 * yy - p) for p in (0.0, 1.0, 2.0)], -1)
    img = 0.8 * base[None] + 0.25 * rng.standard_normal((b, h, w, 3))
    return np.clip(img, -1.0, 1.0).astype(np.float32)


def _cfgs(name, **kw):
    return JAttackConfig(augmentation=name, **kw), AttackConfig(augmentation=name, **kw)


def test_attack_config_defaults_match():
    import dataclasses

    assert dataclasses.asdict(AttackConfig()) == dataclasses.asdict(JAttackConfig())
    assert atk.make_attack(AttackConfig()) is None and atk.make_solver_attack(AttackConfig(), "None") is None
    x = torch.zeros(1, 16, 16, 3)
    assert atk.apply_attack(None, x) is x
    with pytest.raises(ValueError):
        atk.make_attack(AttackConfig(augmentation="Rotate"))
    with pytest.raises(ValueError):
        atk.make_solver_attack(AttackConfig(), "Rotate")


@pytest.mark.parametrize("size,sigma", [(25, 0.5), (25, 2.0), (5, 1.0)])
def test_blur_matches_jax(size, sigma):
    x = _images(32, 48)
    want = np.asarray(jatk.gaussian_blur(jnp.asarray(x), sigma=sigma, size=size))
    got = atk.gaussian_blur(torch.from_numpy(x), sigma, size).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("h,w,ratio", [(32, 32, 0.9), (48, 32, 0.75), (33, 47, 0.5)])
def test_crop_matches_jax_edges_included(h, w, ratio):
    x = _images(h, w, seed=1)
    want = np.asarray(jatk.center_crop(jnp.asarray(x), ratio=ratio))
    got = atk.center_crop(torch.from_numpy(x), ratio).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    # the outermost rows and columns, where half-pixel centres fall outside the patch
    for sl in (np.s_[:, 0], np.s_[:, -1], np.s_[:, :, 0], np.s_[:, :, -1]):
        np.testing.assert_allclose(got[sl], want[sl], atol=ATOL)


def test_noise_matches_jax_given_its_draw():
    x = _images(32, 32, seed=2)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jatk.gaussian_noise(jnp.asarray(x), key, std=0.1))
    unit = torch.from_numpy(np.array(jax.random.normal(key, x.shape, jnp.float32)))
    got = atk.gaussian_noise(torch.from_numpy(x), std=0.1, noise=unit).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert (np.abs(got) == 1.0).any()  # the clamp was exercised
    # its own generator: the same seed gives the same noise, another seed other noise
    a, b, c = (atk.gaussian_noise(torch.from_numpy(x), torch.Generator().manual_seed(s), 0.1)
               for s in (3, 3, 4))
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("quality", [50, 80, 20])
def test_jpeg_diff_round_matches_jax(quality):
    x = _images(32, 48, seed=3)
    want = np.asarray(jatk.jpeg_attack(jnp.asarray(x), quality=quality, differentiable=True))
    got = atk.jpeg_attack(torch.from_numpy(x), quality, differentiable=True).numpy()
    np.testing.assert_allclose(got, want, atol=JPEG_ATOL)


@pytest.mark.parametrize("quality", [50, 80])
def test_jpeg_hard_round_matches_jax_on_all_but_flipped_blocks(quality):
    x = _images(64, 64, seed=4, b=4)
    want = np.asarray(jatk.jpeg_attack(jnp.asarray(x), quality=quality, differentiable=False))
    got = atk.jpeg_attack(torch.from_numpy(x), quality, differentiable=False).numpy()
    close = np.abs(got - want) <= JPEG_ATOL
    assert close.mean() >= 0.999, f"{(~close).sum()} of {close.size} pixels differ"
    assert not np.allclose(got, x, atol=1e-2)  # it did compress


def test_jpeg_pieces():
    assert atk.quality_to_factor(50) == 1.0 and atk.quality_to_factor(25) == 2.0
    v = torch.tensor([0.5, 1.5, 2.5, -0.5, 0.3])
    assert torch.equal(torch.round(v), torch.tensor([0.0, 2.0, 2.0, -0.0, 0.0]))  # half to even, as jnp.round
    np.testing.assert_allclose(atk.diff_round(v).numpy(), np.asarray(jatk.diff_round(jnp.asarray(v.numpy()))))
    with pytest.raises(ValueError):
        atk.jpeg_attack(torch.zeros(1, 24, 32, 3))


@pytest.mark.parametrize("name", NAMES)
def test_make_attack_matches_jax(name):
    """The eval-mode attack the pipeline builds, at the default strengths."""
    jcfg, cfg = _cfgs(name)
    x = _images(32, 32, seed=5)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jatk.apply_attack(jatk.make_attack(jcfg, is_train=False), jnp.asarray(x), key))
    # Noise draws from the key itself, Combination from the second of three splits
    k_noise = key if name == "Noise" else jax.random.split(key, 3)[1]
    unit = torch.from_numpy(np.array(jax.random.normal(k_noise, x.shape, jnp.float32)))
    got = atk.apply_attack(atk.make_attack(cfg), torch.from_numpy(x), noise=unit).numpy()
    assert got.shape == x.shape
    if name in ("Jpeg", "Combination"):  # hard rounding: count, do not take a max
        assert (np.abs(got - want) <= JPEG_ATOL).mean() >= 0.999
    else:
        np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("name", NAMES)
def test_solver_attack_and_its_gradient_match_jax(name):
    jcfg, cfg = _cfgs(name, jpeg_quality=60, blur_sigma=1.0, crop_ratio=0.8)
    x = _images(32, 32, seed=6)
    w = _images(32, 32, seed=7)  # a fixed cotangent
    jfn = jatk.make_solver_attack(jcfg, name)
    jy, vjp = jax.vjp(jfn, jnp.asarray(x))
    jg = np.asarray(vjp(jnp.asarray(w))[0])
    xt = torch.from_numpy(x).requires_grad_(True)
    ty = atk.make_solver_attack(cfg, name)(xt)
    (tg,) = torch.autograd.grad(ty, xt, torch.from_numpy(w))
    tol = JPEG_ATOL if name in ("Jpeg", "Combination") else ATOL
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), atol=tol)
    assert np.isfinite(tg.numpy()).all()
    np.testing.assert_allclose(tg.numpy(), jg, atol=1e-4 * max(1.0, np.abs(jg).max()))
    if name == "Noise":
        assert torch.equal(ty, xt)


# one compile a configuration: op by op JAX compiles each primitive alone
_jblur_random = jax.jit(jatk.gaussian_blur_random, static_argnames=("sigmas", "sizes"))
_jrandom_crop = jax.jit(jatk.random_crop, static_argnames=("ratio",))


def _jax_key_drawing(fn, want):
    """The first PRNGKey(i) whose draw ``fn(key)`` equals ``want``."""
    for i in range(200):
        key = jax.random.PRNGKey(i)
        if fn(key) == want:
            return key
    raise AssertionError(f"no key draws {want}")


@pytest.mark.parametrize("choice", [0, 1, 2])
def test_random_blur_matches_jax_at_each_draw(choice):
    """Each filter size the train-mode blur can draw (3, 5, 9 with one sigma;
    a second sigma list follows the index, clamped), given JAX's draw."""
    x = _images(24, 24, seed=8)
    for sigmas, sizes in (((1.5,), (3, 5, 9)), ((0.5, 1.0), (3, 5, 25))):
        key = _jax_key_drawing(lambda k: int(jax.random.randint(k, (), 0, len(sizes))), choice)
        want = np.asarray(_jblur_random(jnp.asarray(x), key, sigmas=sigmas, sizes=sizes))
        got = atk.gaussian_blur_random(torch.from_numpy(x), sigmas=sigmas, sizes=sizes, choice=choice).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL)
        # the masked kernel is the small kernel: the eval-mode blur at the chosen size
        if choice < len(sizes) - 1:
            small = atk.gaussian_blur(torch.from_numpy(x), sigmas[min(choice, len(sigmas) - 1)], sizes[choice])
            np.testing.assert_allclose(got, small.numpy(), atol=ATOL)


@pytest.mark.parametrize("h,w,ratio", [(32, 32, 0.75), (33, 40, 0.9)])
def test_random_crop_matches_jax_at_each_draw(h, w, ratio):
    """Offsets at both corners and inside, given JAX's draws (y0, x0)."""
    x = _images(h, w, seed=9)
    ch, cw = max(1, int(h * ratio)), max(1, int(w * ratio))

    def offset(key):
        ky, kx = jax.random.split(key)
        return int(jax.random.randint(ky, (), 0, h - ch + 1)), int(jax.random.randint(kx, (), 0, w - cw + 1))

    seen = set()
    for i in range(12):
        key = jax.random.PRNGKey(100 + i)
        y0x0 = offset(key)
        seen.add(y0x0)
        want = np.asarray(_jrandom_crop(jnp.asarray(x), key, ratio=ratio))
        got = atk.random_crop(torch.from_numpy(x), ratio=ratio, offset=y0x0).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL)
    for corner in ((0, 0), (h - ch, w - cw)):
        got = atk.random_crop(torch.from_numpy(x), ratio=ratio, offset=corner).numpy()
        want = np.asarray(jax.image.resize(jnp.asarray(x[:, corner[0]:corner[0] + ch, corner[1]:corner[1] + cw]),
                                           x.shape, "bilinear"))
        np.testing.assert_allclose(got, want, atol=ATOL)
    assert len(seen) > 1


def test_train_mode_attacks_draw_from_their_generator():
    """make_attack(is_train=True): Blur and Crop draw their strength from the
    generator (one seed, one result), Jpeg rounds differentiably as JAX's train
    mode does, Combination applies members with probability 0.5."""
    x = torch.from_numpy(_images(32, 32, seed=10))
    for name in ("Blur", "Crop"):
        fn = atk.make_attack(AttackConfig(augmentation=name), is_train=True)
        a, b = fn(x, torch.Generator().manual_seed(1)), fn(x, torch.Generator().manual_seed(1))
        assert torch.equal(a, b) and a.shape == x.shape
        outs = {fn(x, torch.Generator().manual_seed(s)).sum().item() for s in range(8)}
        assert len(outs) > 1  # the draw matters
    g = torch.Generator().manual_seed(3)
    choice = int(torch.randint(0, 3, (), generator=g))
    want = atk.gaussian_blur_random(x, sigmas=(0.5,), sizes=(3, 5, 25), choice=choice)
    torch.testing.assert_close(atk.make_attack(AttackConfig(augmentation="Blur"), is_train=True)(
        x, torch.Generator().manual_seed(3)), want)
    jcfg, cfg = _cfgs("Jpeg")
    want = np.asarray(jatk.make_attack(jcfg, is_train=True)(jnp.asarray(x.numpy()), None))
    got = atk.make_attack(cfg, is_train=True)(x).numpy()
    np.testing.assert_allclose(got, want, atol=JPEG_ATOL)
    comb = atk.make_attack(AttackConfig(augmentation="Combination"), is_train=True)
    applied = [torch.rand(3, generator=torch.Generator().manual_seed(s)) > 0.5 for s in range(6)]
    for s, mask in enumerate(applied):
        got = comb(x, torch.Generator().manual_seed(s))
        assert torch.equal(got, x) == (not bool(mask.any()))


def test_pipeline_augment_applies_the_configured_attack():
    from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.config import (
        FingerprintConfig,
        ModelConfig,
    )
    from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.fingerprint import (
        pipeline as pl,
    )

    mcfg = ModelConfig(img_size=16, style_dim=16, n_mlp=1, channel_max=16)
    fpcfg = FingerprintConfig(key_len=4, shift=8, n_pca_samples=100)
    x = torch.from_numpy(_images(16, 16, seed=8))
    plain = pl.build_pipeline(mcfg, fpcfg, device="cpu", want_lpips=False)
    assert plain.attack is None and pl.augment(plain, x) is x
    pipe = pl.build_pipeline(mcfg, fpcfg, device="cpu", want_lpips=False,
                             attack_cfg=AttackConfig(augmentation="Noise", noise_sigma=0.2))
    a = pl.augment(pipe, x, torch.Generator().manual_seed(1))
    b = pl.augment(pipe, x, torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, x) and float((a - x).std()) > 0.1
