"""The LPIPS distance head's CUDA kernels (``ops/lpips_head_cuda.py``,
``csrc/lpips_head.cu``) against the plain chain, forward ``d`` and backward
``df``, and the launch geometry and CPU route on the CPU.

The kernel cases are marked ``gpu`` and skip (with a reason) without a CUDA
device; on a GPU machine: ``python -m pytest tests/test_torch_lpips_head.py -q
-m gpu --noconftest``.  Both sides run on the card, the plain chain in
PyTorch's kernels.  Tolerances, all from the order of the sums (the kernels sum
a pixel's channels as a shuffle tree over lanes and the pixels block by block;
PyTorch sums in its own order) and from nothing else, since the kernels round
at the plain chain's points:

- float32: ``d`` to 2e-5 relative (a sum of positive terms); ``df`` to 1e-5
  of max|df| (its channel sum ``s_px`` cancels, so the error is absolute).
- bfloat16: a norm one float32 ulp apart moves a normalized feature across a
  bf16 rounding boundary once in ~2^16 elements, and the difference ``e`` with
  it by one bf16 ulp: ``d`` to 1e-3 relative; ``df`` rounded to bf16 within
  2^-7 of max|df| (an ulp of the largest value, where an ``s_px`` in another
  order rounds the other way), and at least 99% of its elements bitwise equal.
"""

import pytest
import torch

from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.losses import lpips
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.ops import _cuda
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.ops import lpips_head_cuda as H

EPS = 1e-10
HEAD_KERNELS = ("lpips_head_fwd", "lpips_head_bwd", "lpips_head_fwd_bf16", "lpips_head_bwd_bf16")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU or interpret mode")
    return torch.device("cuda")


def _rand(*shape, seed=0):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


def _inputs(s, n, h, w, c, dtype, seed=0, t_chains=1):
    """Post-ReLU raw features f [s, n, h, w, c], unit-norm targets t [s, t_chains, h, w, c]
    in f's dtype, positive lin heads [c] (float32), a cotangent g [s, n]."""
    f = torch.relu(_rand(s, n, h, w, c, seed=seed)) * 3.0
    f[..., 0] += (f.amax(dim=-1) == 0).float()  # no pixel all zero (at C = 6 one in 64 would be)
    t = torch.relu(_rand(s, t_chains, h, w, c, seed=seed + 1))
    t = t / (t.norm(dim=-1, keepdim=True) + EPS)
    lin = torch.rand(c, generator=torch.Generator().manual_seed(seed + 2)) / c
    g = _rand(s, n, seed=seed + 3)
    return f.to(dtype), t.to(dtype), lin, g


def _plain(f, t, lin, g):
    d, norm = H.lpips_head_plain_forward(f, t, lin, EPS)
    return d, H.lpips_head_plain_backward(f, t, lin, norm, g, EPS)


def _kernel(f, t, lin, g):
    return H.lpips_head_forward(f, t, lin, EPS), H.lpips_head_backward(f, t, lin, g, EPS)


def _hold(d, df, dp, dfp):
    assert d.dtype == dp.dtype == torch.float32 and df.dtype == dfp.dtype and df.shape == dfp.shape
    assert torch.isfinite(d).all() and torch.isfinite(df).all()
    scale = dfp.float().abs().max().item()
    if df.dtype == torch.float32:
        torch.testing.assert_close(d, dp, rtol=2e-5, atol=0)
        assert (df - dfp).abs().max().item() <= 1e-5 * scale
    else:
        torch.testing.assert_close(d, dp, rtol=1e-3, atol=0)
        assert (df.float() - dfp.float()).abs().max().item() <= 2.0 ** -7 * scale
        assert (df == dfp).float().mean().item() >= 0.99


# C: the VGG slices (64-512), AlexNet's 192 and 384; odd h and w; S = 2 samples x n = 3
# chains against t [S, 1, ...] broadcast over the chains, as the solver hands it over
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("c", [64, 128, 192, 384, 512])
def test_head_kernels_match_the_plain_chain(cuda, dtype, c):
    f, t, lin, g = (x.to(cuda) for x in _inputs(2, 3, 13, 9, c, dtype, seed=c))
    _cuda.reset_launches()
    d, df = _kernel(f, t, lin, g)
    torch.cuda.synchronize()
    sfx = "_bf16" if dtype == torch.bfloat16 else ""
    assert {k: v for k, v in _cuda.launch_counts().items() if v} == {"lpips_head_fwd" + sfx: 1,
                                                                       "lpips_head_bwd" + sfx: 1}
    _hold(d, df, *_plain(f, t, lin, g))


# the other routes through the same kernels: C off the 16-byte vector (the scalar
# instantiation), t not broadcast (one target a chain), more chains than a block walks
# (64), one leading dim, and a map at the 256px cell's first-slice shape (20 chains)
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", ["scalar_c20", "scalar_c6", "t_per_chain", "chains_70", "lead_1d", "cell_256"])
def test_head_kernels_other_routes(cuda, dtype, case):
    shape = {"scalar_c20": (2, 3, 7, 5, 20), "scalar_c6": (1, 4, 9, 9, 6), "t_per_chain": (2, 3, 11, 7, 64),
             "chains_70": (1, 70, 5, 6, 128), "lead_1d": (1, 5, 15, 15, 64), "cell_256": (1, 20, 256, 256, 64)}[case]
    f, t, lin, g = (x.to(cuda) for x in _inputs(*shape, dtype, t_chains=3 if case == "t_per_chain" else 1))
    if case == "lead_1d":  # [B, h, w, C] against t [B, h, w, C], as the plain distance's callers hand it over
        f, t, g = f[0], t[0].expand(f.shape[1:]).contiguous(), g[0]
    d, df = _kernel(f, t, lin, g)
    torch.cuda.synchronize()
    _hold(d, df, *_plain(f, t, lin, g))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_head_kernels_on_a_permuted_view(cuda, dtype):
    """AlexNet's and SqueezeNet's features are NHWC views of NCHW maps: the
    wrapper makes them contiguous, and the result is the contiguous input's."""
    f, t, lin, g = _inputs(2, 3, 9, 11, 192, dtype, seed=5)
    nchw = f.reshape(6, 9, 11, 192).permute(0, 3, 1, 2).contiguous().to(cuda)
    view = nchw.permute(0, 2, 3, 1).reshape(2, 3, 9, 11, 192)
    assert not view.is_contiguous()
    t, lin, g = t.to(cuda), lin.to(cuda), g.to(cuda)
    d, df = _kernel(view, t, lin, g)
    d0, df0 = _kernel(view.contiguous(), t, lin, g)
    torch.cuda.synchronize()
    assert torch.equal(d, d0) and torch.equal(df, df0)
    _hold(d, df, *_plain(view, t, lin, g))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_head_kernels_at_a_zero_pixel(cuda, dtype):
    """A pixel whose features are all zero: the forward as the plain chain's
    (finite: its normalized feature is 0), the backward 0 / 0 = NaN over that
    pixel's channels on both sides, as JAX's ``_fsd_bwd`` gives; the rest held."""
    f, t, lin, g = (x.to(cuda) for x in _inputs(2, 3, 7, 9, 64, dtype, seed=9))
    f[1, 2, 3, 4] = 0
    d, df = _kernel(f, t, lin, g)
    dp, dfp = _plain(f, t, lin, g)
    torch.cuda.synchronize()
    nan = torch.isnan(dfp)
    assert torch.equal(torch.isnan(df), nan) and nan[1, 2, 3, 4].all() and int(nan.sum()) == 64
    _hold(d, torch.nan_to_num(df), dp, torch.nan_to_num(dfp))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_head_kernels_are_bitwise_repeatable(cuda, dtype):
    """Two calls on one input give the same bits: the forward's spatial mean is
    summed in a fixed order (no float atomics), at a map of ~2,000 blocks."""
    f, t, lin, g = (x.to(cuda) for x in _inputs(1, 20, 128, 128, 128, dtype, seed=11))
    a, b = _kernel(f, t, lin, g), _kernel(f, t, lin, g)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.gpu
def test_distance_from_raw_features_runs_the_kernels_on_the_card(cuda):
    """The solver's entry point: on CUDA features each slice is one forward and
    one backward launch, the plain chain never runs; d and df as the CPU's."""
    feats, tgts, lins = [], [], []
    for i, (c, h) in enumerate(((64, 16), (128, 8), (256, 4))):
        f, t, lin, _ = _inputs(2, 3, h, h, c, torch.float32, seed=20 + i)
        feats.append(f)
        tgts.append(t)
        lins.append(lin)

    def run(dev):
        fs = [f.to(dev).requires_grad_(True) for f in feats]
        d = lpips.distance_from_raw_features({"lin": [w.to(dev) for w in lins]}, fs, [t.to(dev) for t in tgts])
        grads = torch.autograd.grad((d * torch.arange(1.0, 7.0, device=dev).reshape(2, 3)).sum(), fs)
        return d.detach().cpu(), [x.cpu() for x in grads]

    want = run("cpu")
    _cuda.reset_launches()
    got = run(cuda)
    torch.cuda.synchronize()
    assert {k: v for k, v in _cuda.launch_counts().items() if v} == {"lpips_head_fwd": 3, "lpips_head_bwd": 3}
    torch.testing.assert_close(got[0], want[0], rtol=2e-5, atol=0)
    for a, b in zip(got[1], want[1]):
        assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cpu_tensors_take_the_plain_chain(dtype):
    """On the CPU the head is the plain chain, bit for bit, and launches nothing."""
    f, t, lin, g = _inputs(2, 3, 5, 7, 32, dtype, seed=3)
    _cuda.reset_launches()
    fr = f.clone().requires_grad_(True)
    d = lpips.distance_from_raw_features({"lin": [lin]}, [fr], [t])
    (df,) = torch.autograd.grad(d, fr, g)
    dp, dfp = _plain(f, t, lin, g)
    assert torch.equal(d, dp) and torch.equal(df, dfp) and df.dtype == dtype
    assert all(_cuda.launch_counts()[k] == 0 for k in HEAD_KERNELS)


# (S, N, h, C, vector width): the two attribution cells' five slices at 20 chains
# (256px float32, 1024px bf16), AlexNet's 192 / 384, the scalar route, 70 chains
GEOMETRY_CASES = [(1, 20, 256, 64, 4), (1, 20, 128, 128, 4), (1, 20, 64, 256, 4), (1, 20, 32, 512, 4),
                  (1, 20, 16, 512, 4), (1, 20, 1024, 64, 8), (1, 20, 512, 128, 8), (1, 20, 64, 512, 8),
                  (2, 3, 13, 192, 8), (2, 3, 13, 384, 4), (2, 3, 7, 20, 1), (1, 70, 5, 128, 8)]


@pytest.mark.parametrize("s,n,h,c,vec", GEOMETRY_CASES)
def test_head_geometry_covers_every_pixel_and_channel(s, n, h, c, vec):
    """The launch covers each pixel once, in whole tiles, each channel once:
    lanes a pixel a power of two no wider than the pixel's vectors, so that no
    group straddles two pixels' shuffles; about TARGET_BLOCKS blocks in all."""
    gm = H.head_geometry(s, n, h * h, c, vec)
    nvec, lanes = c // vec, gm["lanes"]
    assert lanes & (lanes - 1) == 0 and lanes <= min(32, nvec) < 2 * lanes
    smaller = {1: 0, 2: 1, 4: 2, 8: 4}[gm["kvec"]]  # the next smaller choice would not hold the pixel
    assert smaller * lanes < nvec <= gm["kvec"] * lanes
    tile = (H.THREADS // 32) * (32 // lanes)
    assert gm["pix_per_block"] % tile == 0
    assert (gm["blocks"] - 1) * gm["pix_per_block"] < h * h <= gm["blocks"] * gm["pix_per_block"]
    chunks = -(-n // H.CHAINS)
    assert gm["blocks"] <= -(-H.TARGET_BLOCKS // (s * chunks)) or gm["pix_per_block"] == tile


def test_head_geometry_refuses_a_pixel_wider_than_a_warp_holds():
    with pytest.raises(ValueError, match="exceeds"):
        H.head_geometry(1, 1, 4, 257, 1)
    assert H.head_geometry(1, 1, 4, 256, 1)["kvec"] == 8


@pytest.mark.parametrize("dtype,img", [("float32", 256), ("bfloat16", 1024)])
def test_head_counts_and_launches_at_the_cells_shapes(dtype, img):
    """``ops/roofline.py``'s head at 20 chains against one target, the two
    attribution cells' shapes: the forward reads the chains' maps and the
    target once, the backward reads both and writes df once, both bound by
    bytes; one launch each way a slice, five a solve step.  In bf16 that is
    6.2 bytes a feature element over both directions."""
    from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.ops import roofline

    size = 2 if dtype == "bfloat16" else 4
    shapes = roofline.lpips_head_shapes(img)
    per_map = sum(c * h * h for c, h in shapes)
    fwd, bwd = roofline.main_path("lpips_head_fwd", 20, dtype, img), roofline.main_path("lpips_head_bwd", 20, dtype, img)
    assert [label for label, _ in fwd] == [f"C{c}_H{h}" for c, h in shapes] == [label for label, _ in bwd]
    assert sum(x["bytes"] for _, x in fwd) == size * 21 * per_map
    assert sum(x["bytes"] for _, x in bwd) == size * 41 * per_map
    for _, x in fwd + bwd:
        assert x["bound_by"] == "bytes" and x["bound_ms"] == pytest.approx(1e3 * x["bytes"] / roofline.PEAK_BYTES)
    sfx = "_bf16" if dtype == "bfloat16" else ""
    launches = roofline.step_launches(dtype, img)
    assert launches["lpips_head_fwd" + sfx] == launches["lpips_head_bwd" + sfx] == len(shapes) == 5
    if dtype == "bfloat16":
        total = sum(x["bytes"] for _, x in fwd + bwd)
        assert total / (20 * per_map) == pytest.approx(6.2)
