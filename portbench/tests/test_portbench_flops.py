"""The frozen counts against hand counts at small shapes, against the
port's own kernel counts, and at 256px against the ~260 GFLOP a chain-step
that the XLA cost model of the JAX package read (258)."""

from __future__ import annotations

import importlib

import pytest

from portbench.core import PORT
from portbench.flops import kernels, lpips_vgg16, peaks, stylegan2

SMALL = dict(img_size=8, style_dim=4, channel_multiplier=2, channel_max=2)


def test_synthesis_forward_by_hand():
    # 8px, 2 channels everywhere: conv1 3x3 2->2 at 4x4, ToRGB 2->3 at 4x4; then at 8x8 the
    # transposed 3x3 2->2 on 4x4 inputs, its blur (16 taps), the 3x3 2->2, the ToRGB and the skip upsample.
    conv = 2 * 9 * 2 * 2 * 16 + 2 * 2 * 3 * 16 + 2 * 9 * 2 * 2 * 16 + 2 * 9 * 2 * 2 * 64 + 2 * 2 * 3 * 64
    fir = 2 * 16 * 2 * 64 + 9 * 3 * 64
    style = 2 * 4 * 2 * 2 + 2 * 4 * (2 + 2 + 2)
    f = stylegan2.forward_flops(SMALL)
    assert (f["conv"], f["fir"], f["style"]) == (conv, fir, style)
    s = stylegan2.synthesis(SMALL, 3, "float32", True)
    assert s["flops"] == 2 * 3 * (conv + fir + style)


def test_synthesis_params_by_hand():
    # input 16*2; conv1 9*2*2 + mod 4*2 + 2, noise 1, bias 2; to_rgb1 2*3 + 4*2 + 2, bias 3;
    # then two styled convs (2->2) and a ToRGB at 8px
    styled = 9 * 2 * 2 + 4 * 2 + 2 + 1 + 2
    rgb = 2 * 3 + 4 * 2 + 2 + 3
    assert stylegan2.n_params(SMALL) == 16 * 2 + styled + rgb + 2 * styled + rgb


def test_lpips_by_hand():
    h = 16
    expect = 2 * 9 * (3 * 64 * h * h + 64 * 64 * h * h + 64 * 128 * (h // 2) ** 2 + 128 * 128 * (h // 2) ** 2
                      + 128 * 256 * (h // 4) ** 2 + 2 * 256 * 256 * (h // 4) ** 2 + 256 * 512 * (h // 8) ** 2
                      + 2 * 512 * 512 * (h // 8) ** 2 + 3 * 512 * 512 * (h // 16) ** 2)
    assert lpips_vgg16.forward_flops(h) == expect
    assert lpips_vgg16.lpips(h, 5, "bfloat16", True)["flops"] == 2 * 5 * expect


def test_chain_step_at_256px():
    cfg = dict(img_size=256, style_dim=512, channel_multiplier=2, channel_max=512)
    step = stylegan2.synthesis(cfg, 1, "float32", True)["flops"] + lpips_vgg16.lpips(256, 1, "float32", True)["flops"]
    assert step == pytest.approx(261.66e9, rel=1e-3)
    assert step == pytest.approx(258e9, rel=0.02)
    assert stylegan2.n_params(cfg) == pytest.approx(27.93e6, rel=1e-3)


def test_bound_picks_the_larger():
    assert peaks.bound_s(165e12, 0.0, "float32") == pytest.approx(1.0)
    assert peaks.bound_s(0.0, 3.35e12, "bfloat16") == pytest.approx(1.0)
    assert peaks.bound_s(989e12, 1.0, "bfloat16") == pytest.approx(1.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_counts_match_the_port(dtype):
    roof = importlib.import_module(f"{PORT}.ops.roofline")
    pairs = [(kernels.blur4(4, 128, 33, 33, (1, 1), dtype), roof.blur4(4, 128, 33, 33, (1, 1), dtype)),
             (kernels.upblur4(4, 3, 16, 16, True, dtype), roof.upblur4(4, 3, 16, 16, True, dtype)),
             (kernels.upblur4_adj(4, 3, 16, 16, dtype), roof.upblur4_adj(4, 3, 16, 16, dtype)),
             (kernels.upblur4_chain(4, 3, 4, 6, dtype), roof.upblur4_chain(4, 3, 4, 6, dtype)),
             (kernels.upblur4_adj_chain(4, 3, 4, 6, dtype), roof.upblur4_adj_chain(4, 3, 4, 6, dtype)),
             (kernels.conv3x3(4, 32, 32, 256, dtype), roof.conv3x3(4, 32, 32, 256, dtype)),
             (kernels.slice1_fwd(4, 64, 64, dtype), roof.slice1_fwd(4, 64, 64, dtype)),
             (kernels.slice1_bwd(4, 64, 64, dtype), roof.slice1_bwd(4, 64, 64, dtype))]
    for mine, theirs in pairs:
        assert mine == pytest.approx(theirs)
