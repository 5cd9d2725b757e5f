"""BigGAN-deep-512 on the port's normal path, on the CPU: the published layer
tables by image size (``BigGANConfig.for_size``), the pipeline and the CLI
configuration at 512px, a 14-layer ``pytorch_pretrained_biggan`` state dict,
and the port's generator and solve step against the benchmark's plain
reference (``portbench/reference/biggan.py``, which shares no code with the
port) on seeded weights with a non-zero attention gamma.

The comparison runs at tiny widths with the 512 table's structure: 14
layers, attention before layer 8, the last two at one channel multiple (four
of the seven upsamplings kept, so the image is 64px).  Its truncation, 0.373,
lies between two of the stored statistics rows (0.4 lands on row 20 exactly,
where no blend happens; 0.37 halfway, where swapped weights blend the same).
Planted faults of the port each fail the image comparison: gamma forced to
0, the skip keeping the wrong half of the channels, the statistics blend's
weights swapped, the attention's softmax taken over the queries.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.cli import common as cli_common
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.config import (
    AttributionConfig,
    FingerprintConfig,
    ModelConfig,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.fingerprint import (
    attribute as attr,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.fingerprint import (
    pipeline as pl,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.models import biggan as bg
from portbench.reference import biggan as rb
from portbench.reference import lpips_vgg16 as rlp

UPS_KEPT = (7, 9, 11, 13)  # of the 512 table's seven upsamplings (layers 1, 3, ..., 13)
TINY_LAYERS = tuple((up and i in UPS_KEPT, i_m, o_m) for i, (up, i_m, o_m) in enumerate(bg.BIGGAN_DEEP_512_LAYERS))
TRUNCATION = 0.373
TINY = dict(z_dim=16, class_embed_dim=8, channel_width=8, num_classes=10, n_stats=51, eps=1e-4,
            attention_layer_position=8, layers=[list(t) for t in TINY_LAYERS], truncation=TRUNCATION, **{"class": 3},
            img_size=64, key_len=4, shift=8, sigma=1.0, sd_moved=1.0)
BCFG = bg.BigGANConfig(z_dim=16, class_embed_dim=8, channel_width=8, num_classes=10, output_dim=64,
                       attention_layer_position=8, layers=TINY_LAYERS, n_stats=51)
IMAGE_ATOL = 1e-5  # the port's and the reference's float32 arithmetic differ in order only: ~1e-6 apart


@pytest.fixture
def direct_cpu_convs():
    """PyTorch's direct CPU convs, as the other parity tests use: oneDNN's
    pick their algorithm by the host and shape."""
    before = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    yield
    torch.backends.mkldnn.enabled = before


@pytest.fixture(scope="module")
def drawn():
    g = torch.Generator().manual_seed(2 ** 31 + 21)
    params = rb.make_params(TINY, g, "cpu")
    z = rb.truncated_noise(3, TRUNCATION, TINY["z_dim"], g, "cpu")
    return params, z


def _port_image(params, z):
    onehot = torch.from_numpy(bg.one_hot_from_int(TINY["class"], TINY["num_classes"], z.shape[0]))
    with torch.no_grad():
        return bg.generate(params, z, onehot, TRUNCATION, BCFG)


def _gap(port_params, params, z):
    """The largest difference of the port's image (of ``port_params``) from
    the reference's (of ``params``)."""
    with torch.no_grad():
        return float((_port_image(port_params, z) - rb.generate(params, z, TINY)).abs().max())


def test_reference_imports_neither_the_port_nor_jax():
    code = ("import sys; from portbench.reference import biggan; "
            "print(sorted({m.split('.', 1)[0] for m in sys.modules}))")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=root)
    assert out.returncode == 0, out.stderr[-2000:]
    tops = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "portbench" in tops and not tops & {"jax", "jaxlib", "flax", bg.__name__.split(".")[0],
                                                "attributing_image_generative_models_using_latent_fingerprints_sg2_tpu"}


def test_for_size_gives_the_published_tables():
    c256, c512 = bg.BigGANConfig.for_size(256), bg.BigGANConfig.for_size(512)
    assert c256 == bg.BigGANConfig() and c256.layers == bg.BIGGAN_DEEP_256_LAYERS and c256.img_size == 256
    assert c512.layers == bg.BIGGAN_DEEP_256_LAYERS + ((False, 1, 1), (True, 1, 1))
    assert (len(c512.layers), sum(up for up, _, _ in c512.layers), c512.img_size, c512.output_dim) == (14, 7, 512, 512)
    # every width as at 256px; the attention at 64 x 64 with 512 channels
    assert dataclasses.replace(c512, layers=c256.layers, output_dim=256) == c256
    assert c512.layers[c512.attention_layer_position - 1][2] * c512.channel_width == 512
    for size in (128, 1024, 64, 300):
        with pytest.raises(ValueError, match="published"):
            bg.BigGANConfig.for_size(size)


def test_pipeline_and_cli_build_biggan_deep_512():
    args = cli_common.build_parser("t").parse_args(
        ["--model", "biggan", "--img_size", "512", "--random_init", "--key_len", "32", "--shift", "96"])
    cfg = cli_common.config_from_args(args)
    fp = dataclasses.replace(cfg.fingerprint, n_pca_samples=500)
    pipe = pl.build_pipeline(cfg.model, fp, device="cpu", want_lpips=False)
    assert pipe.biggan_cfg == bg.BigGANConfig.for_size(512)
    assert len(pipe.gen_params["layers"]) == 14 and pipe.gen_params["attn"]["theta"]["w"].shape == (64, 512, 1, 1)
    assert tuple(pipe.basis.v_cap.shape) == (32, 128)
    img = pl.synthesize(pipe, pipe.basis.mean[None])
    assert img.shape == (1, 512, 512, 3) and bool(torch.isfinite(img).all())
    assert pl.build_pipeline(dataclasses.replace(cfg.model, img_size=256), fp, device="cpu",
                             want_lpips=False).biggan_cfg == bg.BigGANConfig()
    with pytest.raises(ValueError, match="published"):
        pl.build_pipeline(dataclasses.replace(cfg.model, img_size=384), fp, device="cpu", want_lpips=False)


def _state_dict(tree, cfg: bg.BigGANConfig):
    """A ``pytorch_pretrained_biggan`` state dict holding the port tree's
    weights (plain ``.weight`` keys, the attention in its own layer slot, a
    ``conv_to_rgb`` of ``channel_width`` outputs of which the first 3 are the
    image)."""
    sd = {"embeddings.weight": tree["embeddings"], "generator.gen_z.weight": tree["gen_z"]["w"],
          "generator.gen_z.bias": tree["gen_z"]["b"]}

    def put(prefix, p):
        sd[f"{prefix}.weight"] = p["w"]
        if "b" in p:
            sd[f"{prefix}.bias"] = p["b"]

    slot = 0
    for i, layer in enumerate(tree["layers"]):
        if i == cfg.attention_layer_position:
            for k in ("theta", "phi", "g", "o_conv"):
                put(f"generator.layers.{slot}.{k}", tree["attn"][k])
            sd[f"generator.layers.{slot}.gamma"] = tree["attn"]["gamma"].reshape(1)
            slot += 1
        for j in range(4):
            bn_ = layer[f"bn{j}"]
            base = f"generator.layers.{slot}.bn_{j}"
            sd[f"{base}.running_means"], sd[f"{base}.running_vars"] = bn_["running_means"], bn_["running_vars"]
            sd[f"{base}.scale.weight"], sd[f"{base}.offset.weight"] = bn_["scale_w"], bn_["offset_w"]
            put(f"generator.layers.{slot}.conv_{j}", layer[f"conv{j}"])
        slot += 1
    for k in ("running_means", "running_vars", "weight", "bias"):
        sd[f"generator.bn.{k}"] = tree["bn_out"][k]
    rgb = tree["conv_out"]
    extra = cfg.channel_width - 3
    sd["generator.conv_to_rgb.weight"] = torch.cat([rgb["w"], torch.full((extra,) + tuple(rgb["w"].shape[1:]), 0.5)])
    sd["generator.conv_to_rgb.bias"] = torch.cat([rgb["b"], torch.full((extra,), 0.5)])
    return sd


def test_state_dict_of_14_layers_is_read_whole(drawn):
    params, z = drawn
    sd = _state_dict(params, BCFG)
    assert sum(k.endswith("conv_0.weight") for k in sd) == 14
    got = bg.params_from_torch_state_dict(sd, BCFG, device="cpu")
    assert len(got["layers"]) == 14
    torch.testing.assert_close(got["layers"][13]["conv3"]["w"], params["layers"][13]["conv3"]["w"], rtol=0, atol=0)
    torch.testing.assert_close(got["attn"]["gamma"], params["attn"]["gamma"], rtol=0, atol=0)
    assert torch.equal(_port_image(got, z), _port_image(params, z))
    twelve = dataclasses.replace(BCFG, layers=BCFG.layers[:12])
    with pytest.raises(ValueError, match="14 generator layers"):
        bg.params_from_torch_state_dict(sd, twelve, device="cpu")


def test_generator_matches_the_reference(drawn, direct_cpu_convs):
    params, z = drawn
    img = rb.generate(params, z, TINY)
    assert img.shape == (3, 64, 64, 3)
    assert 0.2 < float(img.std()) and float((img.abs() > 0.99).float().mean()) < 0.05  # not saturated
    assert float(params["attn"]["gamma"]) > 0.5
    assert _gap(params, params, z) <= IMAGE_ATOL


def _gamma_zero(params, monkeypatch):
    return {**params, "attn": {**params["attn"], "gamma": torch.zeros(())}}


def _skip_keeps_the_last_half(params, monkeypatch):
    real = bg.gen_block

    def gen_block(x, cond, p, *, up, drop_to, truncation, n_stats):
        out = real(x, cond, p, up=up, drop_to=drop_to, truncation=truncation, n_stats=n_stats)
        if drop_to is None:
            return out
        wrong = x[:, -drop_to:] - x[:, :drop_to]
        return out + (bg._upsample2x_nearest(wrong) if up else wrong)

    monkeypatch.setattr(bg, "gen_block", gen_block)
    return params


def _blend_swapped(params, monkeypatch):
    def _interp_stats(stats, truncation, n_stats):
        pos = truncation * (n_stats - 1)
        lo = int(np.floor(pos))
        frac = pos - lo
        return stats[lo] * (1.0 - frac) + stats[lo + 1] * frac

    monkeypatch.setattr(bg, "_interp_stats", _interp_stats)
    return params


def _softmax_over_queries(params, monkeypatch):
    real_softmax = torch.softmax

    def self_attention(x, p):
        monkeypatch.setattr(torch, "softmax", lambda t, dim: real_softmax(t, dim=1))
        try:
            return real_attention(x, p)
        finally:
            monkeypatch.setattr(torch, "softmax", real_softmax)

    real_attention = bg.self_attention
    monkeypatch.setattr(bg, "self_attention", self_attention)
    return params


@pytest.mark.parametrize("fault", [_gamma_zero, _skip_keeps_the_last_half, _blend_swapped, _softmax_over_queries])
def test_planted_fault_fails_the_comparison(drawn, direct_cpu_convs, monkeypatch, fault):
    params, z = drawn
    gap = _gap(fault(params, monkeypatch), params, z)
    assert gap > 100 * IMAGE_ATOL, gap


def test_solve_step_matches_the_reference(drawn, direct_cpu_convs):
    """One perceptual solve step of 4 restarts at the port's normal path (the
    BigGAN branch of ``make_attribution_step``, the basis of
    ``pca_from_truncated_noise``): the per-restart loss and the gradient of
    alpha and of the key logits against the reference's ``loss_and_grads``."""
    params, _ = drawn
    g = torch.Generator().manual_seed(7)
    lpips_params = rlp.make_params(g, "cpu")
    pca_z = rb.truncated_noise(400, TRUNCATION, TINY["z_dim"], g, "cpu")
    basis = rb.build_basis(pca_z, TINY)
    mcfg = ModelConfig(model="biggan", img_size=64, biggan_label=str(TINY["class"]))
    fp = FingerprintConfig(key_len=TINY["key_len"], shift=TINY["shift"], n_pca_samples=400)
    pipe = pl.build_pipeline(mcfg, fp, device="cpu", gen_params=params, lpips_params=lpips_params, pca_z=pca_z,
                             biggan_cfg=BCFG, truncation=TRUNCATION)
    assert torch.equal(pipe.basis.u_cap, basis["u"]) and torch.equal(pipe.basis.v_cap, basis["v"])
    alpha = torch.randn((1, 4, 12), generator=g) * basis["sigma_rest"] * 2.0  # some restarts outside the box
    key = torch.randn((1, 4, TINY["key_len"]), generator=g)
    _, wx = rb.embed(basis, torch.randn((1, 12), generator=g) * basis["sigma_rest"],
                     torch.randint(0, 2, (1, TINY["key_len"]), generator=g).float(), TINY)
    target = rb.generate(params, wx, TINY).detach()
    acfg = AttributionConfig(steps=1, n_starts=4, loss="perceptual")
    feats, _ = attr._targets_for_loss(pipe.lpips_params, target, acfg)
    _, per_elem = attr.make_attribution_step(pipe.gen_params, pipe.lpips_params, pipe.basis, pipe.noise, mcfg, acfg,
                                             feats, None, **pl.solver_kwargs(pipe))
    a, k = alpha.clone().requires_grad_(True), key.clone().requires_grad_(True)
    per = per_elem(a, k)
    ga, gk = torch.autograd.grad(per.sum(), [a, k])
    ref = {"cfg": TINY, "gen": params, "lpips": lpips_params, "basis": basis}
    solver = {"bound_weight": acfg.bound_weight}
    loss_r, ga_r, gk_r = rb.loss_and_grads(ref, alpha[0], key[0], rlp.target_features(lpips_params, target), solver, 3)
    torch.testing.assert_close(per[0].detach(), loss_r, rtol=1e-5, atol=0)
    for got, want in ((ga[0], ga_r), (gk[0], gk_r)):
        gap = float(torch.linalg.norm((got - want).double()) / torch.linalg.norm(want.double()))
        assert gap <= 1e-4, gap
