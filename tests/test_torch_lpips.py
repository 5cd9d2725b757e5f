"""The port's LPIPS-VGG16 vs the JAX package on the CPU: features, distance,
and the fused distance head's gradient.

The same random backbone goes to both (``params_from_jax``); images are
16x16 so all five slices exist (16 -> 1 pixel).  Tolerance 1e-4 relative
to each quantity's scale: float32 convs over up to 9*512 terms in another
order, through 13 layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.losses import lpips as jlp
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.losses import lpips

RTOL = 1e-4


def _close(got, want):
    np.testing.assert_allclose(got, want, atol=RTOL * max(1.0, float(np.abs(want).max())))


@pytest.fixture(scope="module")
def params():
    jp = jax.jit(jlp.init_lpips_params)(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    # non-uniform lin heads so each channel's weight matters
    jp = dict(jp, lin=tuple(jnp.asarray(rng.uniform(0, 2, c).astype(np.float32) / c)
                            for c in jlp.LPIPS_CHANNELS))
    return jp, lpips.params_from_jax(jp, "cpu")


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(1)
    a = np.tanh(rng.standard_normal((2, 16, 16, 3))).astype(np.float32)
    b = np.tanh(rng.standard_normal((2, 16, 16, 3))).astype(np.float32)
    return a, b


def test_features_match_jax(params, images):
    jp, tp = params
    a, _ = images
    jf = jax.jit(jlp.extract_raw_features)(jp, jnp.asarray(a))
    tf = lpips.extract_raw_features(tp, torch.from_numpy(a))
    assert [tuple(f.shape) for f in tf] == [f.shape for f in jf]
    for t, j in zip(tf, jf):
        _close(t.numpy(), np.asarray(j))
    for t, j in zip(lpips.extract_features(tp, torch.from_numpy(a)),
                    jlp.extract_features(jp, jnp.asarray(a))):
        _close(t.numpy(), np.asarray(j))


def test_distance_matches_jax(params, images):
    jp, tp = params
    a, b = images
    want = np.asarray(jlp.lpips(jp, jnp.asarray(a), jnp.asarray(b)))
    got = lpips.lpips(tp, torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.shape == (2,)
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_fused_head_gradient_matches_jax(params, images):
    """d/d(image) of the raw-feature distance against cached normalized
    target features, broadcast over restarts as in the solver ([S, n] vs [S, 1])."""
    jp, tp = params
    a, b = images
    tgt_j = [f[:, None] for f in jax.jit(jlp.extract_features)(jp, jnp.asarray(b))]
    tgt_t = [f[:, None] for f in lpips.extract_features(tp, torch.from_numpy(b))]

    def jloss(x):
        feats = [f.reshape((2, 1) + f.shape[1:]) for f in jlp.extract_raw_features(jp, x)]
        d = jlp.distance_from_raw_features(jp, feats, tgt_j)
        return jnp.sum(d * jnp.asarray([[1.0], [2.0]])), d

    (_, jd), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jnp.asarray(a))
    x = torch.from_numpy(a).requires_grad_(True)
    feats = [f.reshape((2, 1) + tuple(f.shape[1:])) for f in lpips.extract_raw_features(tp, x)]
    td = lpips.distance_from_raw_features(tp, feats, tgt_t)
    (td * torch.tensor([[1.0], [2.0]])).sum().backward()
    np.testing.assert_allclose(td.detach().numpy(), np.asarray(jd), rtol=RTOL)
    _close(x.grad.numpy(), np.asarray(jg))


def test_fused_head_equals_autograd_of_the_plain_distance(params, images):
    """The hand-written backward equals autograd through normalize + distance."""
    _, tp = params
    a, b = images
    tgt = lpips.extract_features(tp, torch.from_numpy(b))
    f1 = [f.detach().requires_grad_(True) for f in lpips.extract_raw_features(tp, torch.from_numpy(a))]
    lpips.distance_from_raw_features(tp, f1, tgt).sum().backward()
    f2 = [f.detach().requires_grad_(True) for f in f1]
    lpips.distance_from_features(tp, tgt, [lpips.normalize_feat(f) for f in f2]).sum().backward()
    for u, v in zip(f1, f2):
        _close(u.grad.numpy(), v.grad.numpy())


def test_torchvision_state_dict_loaders(tmp_path):
    """torchvision-layout VGG16 + LPIPS lin blob -> the same tree as the JAX loaders."""
    rng = np.random.default_rng(2)
    sd, li, cin = {}, 0, 3
    for item in jlp.VGG16_PLAN:
        if item == "M":
            li += 1
            continue
        sd[f"features.{li}.weight"] = rng.standard_normal((item, cin, 3, 3)).astype(np.float32)
        sd[f"features.{li}.bias"] = rng.standard_normal(item).astype(np.float32)
        li, cin = li + 2, item
    lin = {f"lin{k}.model.1.weight": rng.uniform(size=(1, c, 1, 1)).astype(np.float32)
           for k, c in enumerate(jlp.LPIPS_CHANNELS)}
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, tmp_path / "vgg16.pth")
    torch.save({k: torch.from_numpy(v) for k, v in lin.items()}, tmp_path / "vgg.pth")
    got = lpips.build_lpips_params(device="cpu", vgg_path=str(tmp_path / "vgg16.pth"), lin_path=str(tmp_path / "vgg.pth"))
    want_vgg = jlp.vgg16_params_from_torch_state_dict(sd)
    want_lin = jlp.lin_weights_from_torch_state_dict(lin)
    for g, w in zip(got["vgg"], want_vgg):
        np.testing.assert_array_equal(g["weight"].numpy(), w["weight"])
        np.testing.assert_array_equal(g["bias"].numpy(), w["bias"])
    for g, w in zip(got["lin"], want_lin):
        np.testing.assert_array_equal(g.numpy(), w)
