"""The port's AlexNet and SqueezeNet LPIPS backbones, its distance modes and
the CLIs' LPIPS wiring against the JAX package, on the CPU.

The same numpy parameters (HWIO, the JAX package's layout, drawn from a
seed) and images go through both packages.  Tolerances (float32): feature
maps and distances within 1e-5 of the largest magnitude of the JAX side
(convs of up to 11 x 11 x 3 or 3 x 3 x 512 terms summed in another order);
the state-dict converters exactly.  oneDNN's CPU convs are switched off
for the comparisons: they are less exact than the default ones.  The
SqueezeNet runs at 64 px, where every ceil-mode pool window is whole, and
at 67 px, where the second pool's last window is partial.
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.cli import common as jcommon
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.losses import lpips as jlp
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.cli import common
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.losses import lpips as lp
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.utils.tree import tree_leaves

RTOL = 1e-5


@pytest.fixture(autouse=True)
def no_onednn():
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _rel(got, want) -> float:
    g = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    w = np.asarray(want)
    return float(np.abs(g - w).max() / np.abs(w).max())


def _conv(rng, k, cin, cout):
    return {"weight": (rng.standard_normal((k, k, cin, cout)) * np.sqrt(2.0 / (cin * k * k))).astype(np.float32),
            "bias": (0.1 * rng.standard_normal(cout)).astype(np.float32)}


def _alex(seed=0):
    rng, cin, convs = np.random.default_rng(seed), 3, []
    for cout, k, _, _ in lp._ALEX_CONVS:
        convs.append(_conv(rng, k, cin, cout))
        cin = cout
    return convs


def _squeeze(seed=1):
    rng, cin, fires = np.random.default_rng(seed), 64, []
    conv0 = _conv(rng, 3, 3, 64)
    for s, e1, e3 in lp._SQUEEZE_FIRES:
        fires.append({"squeeze": _conv(rng, 1, cin, s), "expand1x1": _conv(rng, 1, s, e1),
                      "expand3x3": _conv(rng, 3, s, e3)})
        cin = e1 + e3
    return {"conv0": conv0, "fires": fires}


def _params(net):
    """{"net", "lin"} in numpy (lin heads non-uniform), the JAX tree, the port's."""
    raw = _alex() if net == "alex" else _squeeze()
    chans = lp.ALEX_CHANNELS if net == "alex" else lp.SQUEEZE_CHANNELS
    rng = np.random.default_rng(5)
    tree = {"net": raw, "lin": [rng.uniform(0.0, 2.0 / c, c).astype(np.float32) for c in chans]}
    jtree = jax.tree.map(jnp.asarray, {"net": tuple(raw) if net == "alex" else
                                       dict(raw, fires=tuple(raw["fires"])), "lin": tuple(tree["lin"])})
    return tree, jtree, lp.params_from_jax(jtree, "cpu")


# one compile a (net, size): op by op the JAX side compiles every primitive alone
_jfeatures_lpips_net = jax.jit(lambda p, a, b: (jlp.extract_raw_features(p, a), jlp.lpips(p, a, b),
                                                jlp.lpips_net_mode(p, a, b)))


def _images(seed, size, b=2):
    return np.random.default_rng(seed).uniform(-1, 1, (b, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("net", ["alex", "squeeze"])
@pytest.mark.parametrize("size", [64, 67])
def test_backbone_features_and_lpips_match_jax(net, size):
    _, jtree, params = _params(net)
    x, y = _images(size, size), _images(size + 1, size)
    want, want_d, want_net = _jfeatures_lpips_net(jtree, jnp.asarray(x), jnp.asarray(y))
    got = lp.extract_raw_features(params, torch.from_numpy(x))
    chans = lp.ALEX_CHANNELS if net == "alex" else lp.SQUEEZE_CHANNELS
    assert [f.shape[-1] for f in got] == list(chans)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        assert _rel(g, w) < RTOL
    assert _rel(lp.lpips(params, torch.from_numpy(x), torch.from_numpy(y)), want_d) < RTOL
    # "net" mode: no lin heads
    assert _rel(lp.lpips_net_mode(params, torch.from_numpy(x), torch.from_numpy(y)), want_net) < RTOL


def test_backbones_in_bf16_cast_their_weights():
    _, _, params = _params("squeeze")
    x = torch.from_numpy(_images(3, 32)).to(torch.bfloat16)
    feats = lp.extract_raw_features(params, x)
    assert all(f.dtype == torch.bfloat16 for f in feats)
    ref = lp.extract_raw_features(params, x.float())
    assert max(_rel(f.float(), r.numpy()) for f, r in zip(feats, ref)) < 0.05


def test_state_dict_converters_match_jax():
    """Torchvision names ([O, I, kh, kw]) built from the numpy trees come back
    as the same HWIO trees, in both packages."""
    alex, squeeze = _alex(), _squeeze()

    def oihw(p):
        return np.transpose(p["weight"], (3, 2, 0, 1)), p["bias"]

    sd = {}
    for i, p in zip((0, 3, 6, 8, 10), alex):
        sd[f"features.{i}.weight"], sd[f"features.{i}.bias"] = oihw(p)
    got, want = lp.alexnet_params_from_torch_state_dict(sd), jlp.alexnet_params_from_torch_state_dict(sd)
    for g, w, a in zip(got, want, alex):
        for k in ("weight", "bias"):
            np.testing.assert_array_equal(g[k], w[k])
            np.testing.assert_array_equal(g[k], a[k])
    sd = {}
    sd["features.0.weight"], sd["features.0.bias"] = oihw(squeeze["conv0"])
    for i, fire in zip((3, 4, 6, 7, 9, 10, 11, 12), squeeze["fires"]):
        for name, p in fire.items():
            sd[f"features.{i}.{name}.weight"], sd[f"features.{i}.{name}.bias"] = oihw(p)
    got, want = lp.squeezenet_params_from_torch_state_dict(sd), jlp.squeezenet_params_from_torch_state_dict(sd)
    flat_got = tree_leaves(got)
    flat_want = jax.tree.leaves(want)
    assert len(flat_got) == len(flat_want) == len(tree_leaves(squeeze)) == 2 + 8 * 6
    for g, w, a in zip(flat_got, flat_want, tree_leaves(squeeze)):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, a)


def test_extract_raw_features_dispatch_and_build():
    """The backbone follows the params' structure; build_lpips_params makes
    each net with uniform heads of its widths, and refuses an unknown one."""
    x = torch.from_numpy(_images(4, 32, b=1))
    for net, chans in (("vgg", lp.LPIPS_CHANNELS), ("alex", lp.ALEX_CHANNELS), ("squeeze", lp.SQUEEZE_CHANNELS)):
        params = lp.build_lpips_params(torch.Generator().manual_seed(0), "cpu", net=net)
        assert ("vgg" in params) == (net == "vgg") and ("net" in params) == (net != "vgg")
        feats = lp.extract_raw_features(params, x)
        assert [f.shape[-1] for f in feats] == list(chans)
        assert [float(w[0]) for w in params["lin"]] == pytest.approx([1.0 / c for c in chans])
        assert all(t.device.type == "cpu" for t in tree_leaves(params))
    with pytest.raises(ValueError, match="unknown LPIPS net"):
        lp.build_lpips_params(None, "cpu", net="resnet")
    with pytest.raises(ValueError, match="unknown LPIPS net"):
        jlp.build_lpips_params(jax.random.PRNGKey(0), net="resnet")


_jdssim = jax.jit(jlp.dssim_per_sample, static_argnames=("data_range", "win"))


def test_distance_modes_match_jax():
    a, b = _images(6, 40, b=3), _images(7, 40, b=3)
    b[0] = a[0]  # one identical pair
    ta, tb, ja, jb = torch.from_numpy(a), torch.from_numpy(b), jnp.asarray(a), jnp.asarray(b)
    assert _rel(lp.mse_per_sample(ta, tb), jlp.mse_per_sample(ja, jb)) < RTOL
    got, want = lp.dssim_per_sample(ta, tb), np.asarray(_jdssim(ja, jb))
    assert got.shape == (3,) and abs(float(got[0])) < 1e-6
    assert _rel(got, want) < RTOL
    got = lp.dssim_per_sample(ta * 0.5, tb * 0.5, data_range=1.0, win=5)
    assert _rel(got, _jdssim(ja * 0.5, jb * 0.5, data_range=1.0, win=5)) < RTOL


# ---------------------------------------------------------------------------
# the CLIs' LPIPS wiring
# ---------------------------------------------------------------------------


def _args(pkg, argv):
    args = pkg.build_parser("t").parse_args(["--random_init", *argv])
    return args, pkg.config_from_args(args)


@pytest.mark.parametrize("argv,want", [
    ([], (True, None)),
    (["--loss", "mse", "--lpips_net", "alex"], (False, None)),
    (["--lpips_net", "alex"], (False, "net")),
    (["--lpips_net", "squeeze"], (False, "net")),
    (["--lpips_disc", "DISC"], (False, "disc")),
    (["--lpips_net", "squeeze", "--lpips_disc", "DISC"], (False, "disc")),
])
def test_resolve_lpips_matches_jax(argv, want, tmp_path, monkeypatch):
    """(want_default, custom params) over the flag combinations, both packages;
    the custom params are the same structure of the same shapes.  JAX's random
    AlexNet / SqueezeNet draws are replaced by the numpy trees (drawing them
    compiles one program a shape)."""
    from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.checkpoints.flat import (
        flatten_params,
    )
    from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.config import ModelConfig
    from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.models import stylegan2 as sg2

    monkeypatch.setattr(jlp, "init_alex_params", lambda key: tuple(_alex()))
    monkeypatch.setattr(jlp, "init_squeeze_params", lambda key: dict(_squeeze(), fires=tuple(_squeeze()["fires"])))
    disc = sg2.init_discriminator_params(ModelConfig(img_size=8, channel_max=8), torch.Generator().manual_seed(0),
                                         "cpu")
    path = str(tmp_path / "d.disc.npz")
    np.savez(path, **flatten_params(jax.tree.map(lambda t: t.numpy(), disc)))
    argv = [path if a == "DISC" else a for a in argv]
    jargs, jcfg = _args(jcommon, argv)
    args, cfg = _args(common, argv + ["--device", "cpu"])
    (jwant, jparams), (pwant, params) = jcommon.resolve_lpips(jargs, jcfg), common.resolve_lpips(args, cfg)
    assert jwant == pwant == want[0]
    if want[1] is None:
        assert jparams is None and params is None
    else:
        assert want[1] in params and want[1] in jparams
        shapes = [tuple(t.shape) for t in tree_leaves(params)]
        assert shapes == [tuple(t.shape) for t in jax.tree.leaves(jparams)]
        assert all(t.device.type == "cpu" for t in tree_leaves(params))
    # a run that solves nothing builds no LPIPS
    assert common.resolve_lpips(args, cfg, want=False) == (False, None)
    assert jcommon.resolve_lpips(jargs, jcfg, want=False) == (False, None)


def test_lpips_flags_parse_as_in_jax():
    for argv in (["--lpips_net", "squeeze"], ["--lpips_disc", "x.npz"]):
        jargs, _ = _args(jcommon, argv)
        args, _ = _args(common, argv)
        assert (args.lpips_net, args.lpips_disc) == (jargs.lpips_net, jargs.lpips_disc)
    with pytest.raises(SystemExit):
        common.build_parser("t").parse_args(["--lpips_net", "resnet"])
    assert isinstance(common.build_parser("t").parse_args([]), argparse.Namespace)
