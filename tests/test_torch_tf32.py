"""CPU tests of what surrounds the port's tensor-core kernels: the three-pass
TF32 split and its emulation, the weight packing the kernels read, the tiled
plain vgg_slice1 backward that walks the kernel's tiles, and the operation /
byte / bound counts ``chip_smoke.py`` prints beside the measured times.

The JAX functions run as the JAX package's own tests run them on the CPU
(Pallas in TPU interpret mode).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.ops import vgg_pallas as jvgg
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.ops import (
    vgg_slice_pallas as jslice,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.ops import (
    roofline,
    tf32,
    vgg_cuda,
    vgg_slice_cuda,
)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# (a) the three-pass emulation against float32
# ---------------------------------------------------------------------------

# 1e-5 x scale: the split drops a_lo*b_lo (~2^-22 per product) and rounds each lo
# to 2^-22 of its operand; three float32 convolutions are then added, each summed
# over 9*C terms in its own order (~sqrt(9*C) * 2^-24 of the scale).  All of it
# stays under 1e-5 up to C = 512; a single TF32 pass would be ~1e-3.
THREE_PASS_TOL = 1e-5


@pytest.mark.parametrize("c", [64, 128, 256, 512])
def test_three_pass_emulation_matches_float32_conv(c):
    x = torch.from_numpy(_rand((1, 6, 7, c), c))
    w = torch.from_numpy(_rand((3, 3, c, c), c + 1, scale=np.sqrt(2.0 / (9 * c))))
    b = torch.from_numpy(_rand((c,), c + 2, scale=0.1))
    want = vgg_cuda.conv3x3_plain(x, w, b)
    got = tf32.conv3x3_three_pass(x, w, b)
    scale = max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= THREE_PASS_TOL * scale
    # one TF32 pass alone is far outside that tolerance: the split is what holds it
    one = vgg_cuda.conv3x3_plain(tf32.tf32_round(x), tf32.tf32_round(w), b)
    assert (one - want).abs().max().item() > 10 * THREE_PASS_TOL * scale


@pytest.mark.parametrize("c", [64, 128, 256, 512])
def test_three_pass_emulation_matches_jax_conv3x3_relu(c):
    x = _rand((1, 8, 8, c), 10 + c)
    w = _rand((3, 3, c, c), 11 + c, scale=np.sqrt(2.0 / (9 * c)))
    b = _rand((c,), 12 + c, scale=0.1)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jvgg.conv3x3_relu(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    got = torch.relu(tf32.conv3x3_three_pass(*(torch.from_numpy(a) for a in (x, w, b)))).numpy()
    np.testing.assert_allclose(got, want, atol=THREE_PASS_TOL * max(1.0, float(np.abs(want).max())))


# ---------------------------------------------------------------------------
# (b) the split itself
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scale", [1.0, 1e-20, 1e20])
def test_split_reconstructs_to_2_pow_minus_21(scale):
    x = torch.from_numpy(_rand((4096,), 3)) * scale
    hi, lo = tf32.split_tf32(x)
    for part in (hi, lo):  # both parts are TF32 numbers: 13 low mantissa bits clear
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    rel = ((hi.double() + lo.double()) - x.double()).abs() / x.double().abs()
    assert rel.max().item() <= 2.0 ** -21
    assert ((hi - x).abs() <= x.abs() * 2.0 ** -11).all()  # round to nearest: half an ulp of 2^-10


def test_tf32_round_ties_away_from_zero():
    one_ulp = 2.0 ** -10
    x = torch.tensor([1.0 + one_ulp / 2, -(1.0 + one_ulp / 2), 1.0 + one_ulp / 4])
    assert tf32.tf32_round(x).tolist() == [1.0 + one_ulp, -(1.0 + one_ulp), 1.0]


# ---------------------------------------------------------------------------
# (c) the packing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cin,cout,n_tile,layout", [
    pytest.param(64, 64, 64, "tf32", id="64-64-64"),
    pytest.param(128, 128, 64, "tf32", id="128-128-64"),
    pytest.param(64, 3, 8, "tf32", id="64-3-8"),
    # the bf16 `wgmma` kernels' swizzled 64-channel tiles: the conv's two N tiles, and
    # the slice backward's adjoint w2 and w1
    pytest.param(128, 128, 128, "sw128", id="sw128-128-128-128"),
    pytest.param(192, 192, 64, "sw128", id="sw128-192-192-64"),
    pytest.param(64, 64, 64, "sw128", id="sw128-64-64-64"),
    pytest.param(64, 3, 8, "sw128", id="sw128-64-3-8"),
    pytest.param(64, 64, 64, "sw128-fwd", id="sw128-64-64-64-unflipped"),
])
def test_pack_round_trips_and_flipped_form_is_flip_io(cin, cout, n_tile, layout):
    w = torch.from_numpy(_rand((3, 3, cin, cout), 20))
    if layout == "sw128":
        packed = tf32.pack_conv_weights_sw128(w, n_tile)
        assert packed.shape == (-(-cout // n_tile), cin // 64, 9, n_tile, 64) and packed.dtype == torch.bfloat16
        assert torch.equal(tf32.unpack_conv_weights_sw128(packed, cout), w.to(torch.bfloat16))
        # the backward's packing: packed_weights(v, flip=True) of the v whose adjoint w is
        v = tf32.flip_io(w)
        adj = tf32.packed_weights(v, n_tile, flip=True, dtype=torch.bfloat16)
        assert torch.equal(tf32.unpack_conv_weights_sw128(adj, cout), w.to(torch.bfloat16))
        return
    if layout == "sw128-fwd":  # the bf16 slice forward's w2: packed_weights unflipped, as its wrapper asks
        packed = tf32.packed_weights(w, n_tile, dtype=torch.bfloat16)
        assert torch.equal(packed, tf32.pack_conv_weights_sw128(w, n_tile))
        assert torch.equal(tf32.unpack_conv_weights_sw128(packed, cout), w.to(torch.bfloat16))
        return
    packed = tf32.pack_conv_weights(w, n_tile)
    assert packed.shape == (-(-cout // n_tile), cin // 32, 9, 2, n_tile, 32)
    hi, lo = tf32.unpack_conv_weights(packed, cout)
    want_hi, want_lo = tf32.split_tf32(w)
    assert torch.equal(hi, want_hi) and torch.equal(lo, want_lo)
    if cin == cout:  # the dx pass: packed_weights(flip=True) packs the adjoint taps
        fhi, flo = tf32.unpack_conv_weights(tf32.packed_weights(w, n_tile, flip=True), cout)
        adj = tf32.flip_io(w)
        assert torch.equal(fhi, tf32.split_tf32(adj)[0])
        assert (fhi + flo - adj).abs().max().item() <= 2.0 ** -21 * adj.abs().max().item()


def test_packed_tile_read_as_the_kernel_reads_it():
    """One tap x one chunk read back through the kernel's own index rules: row n
    of the [64][32] tile at the swizzled 16-byte chunk, and the thread with
    lane % 4 == t taking k-step s from channels 8 t + 2 s (+ 1) of its pixel."""
    w = torch.from_numpy(_rand((3, 3, 64, 64), 21))
    packed = tf32.pack_conv_weights(w, 64)
    tap, chunk = 5, 1
    tile = packed[0, chunk, tap, 0].reshape(-1)  # hi, as the bytes lie in a stage
    px = torch.from_numpy(_rand((32,), 22))       # one pixel's 32 channels of that chunk
    want = tf32.split_tf32(w)[0].reshape(9, 64, 64)[tap, 32 * chunk:32 * chunk + 32].T @ px
    got = torch.zeros(64)
    for n in range(64):
        for s in range(4):          # k-step
            for t in range(4):      # lane % 4
                for j in range(2):  # fragment registers (a0, a1) and (a2, a3)
                    k = 8 * s + t + 4 * j
                    pos = n * 32 + (((k // 4) ^ (n % 8)) * 4 + k % 4)
                    got[n] += tile[pos] * px[8 * t + 2 * s + j]
    assert torch.allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("cin,cout,n_tile,chunk,tap", [
    (128, 128, 128, 1, 4),   # conv3x3_relu_bf16, C % 128 == 0
    (192, 192, 64, 2, 7),    # conv3x3_relu_bf16, C % 128 == 64
    (64, 64, 64, 0, 8),      # vgg_slice1_bwd_bf16: adjoint w2
    (64, 3, 8, 0, 2),        # vgg_slice1_bwd_bf16: adjoint w1, N padded to 8
])
def test_sw128_stage_read_as_the_descriptor_reads_it(cin, cout, n_tile, chunk, tap):
    """One (chunk, tap) stage of the bf16 `wgmma` packing read back as the B
    descriptor reads it: row n of the [n_tile][64] tile, k-step s the 32 bytes
    at 2 s units of the address field past the row's start, 16-byte chunk
    index XOR n % 8 (the 128-byte swizzle), every 8 rows 1024 bytes on."""
    w = torch.from_numpy(_rand((3, 3, cin, cout), 24))
    packed = tf32.pack_conv_weights_sw128(w, n_tile)
    stage = packed[-1, chunk, tap].reshape(-1).float()  # the bytes of one ring stage, last N tile
    n0 = (packed.shape[0] - 1) * n_tile
    px = torch.from_numpy(_rand((64,), 25))
    rows = min(n_tile, cout - n0)
    want = w.to(torch.bfloat16).float().reshape(9, cin, cout)[tap, 64 * chunk:64 * chunk + 64, n0:n0 + rows].T @ px
    # row n, k-step s (32 bytes = two 16-byte chunks `half`), element e of the chunk
    n, s, half, e = torch.meshgrid(torch.arange(n_tile), torch.arange(4), torch.arange(2), torch.arange(8),
                                   indexing="ij")
    byte = (n // 8) * 1024 + (n % 8) * 128 + (((2 * s + half) ^ (n % 8)) * 16) + 2 * e
    got = (stage[byte // 2] * px[16 * s + 8 * half + e]).sum(dim=(1, 2, 3))
    assert torch.allclose(got[:rows], want, atol=1e-5) and not got[rows:].any()


@pytest.mark.parametrize("band_w,rows,tap", [(18, 8, 4), (18, 8, 8), (18, 16, 0), (18, 16, 5)])
def test_band_fragments_read_as_ldmatrix_reads_them(band_w, rows, tap):
    """The A side of the bf16 `wgmma` kernels: a band of 64-channel pixels in the
    128-byte swizzle (``fp_sw128``: pixel p's 16-byte chunk q at 128 p + 16 (q ^
    p % 8)), lane l of a warp naming pixel (l % 16) of its row at the tap's shift
    and chunk 2 s + l / 16 for ``ldmatrix.x4``; matrix j = lanes 8 j .. 8 j + 7
    gives thread (g, t) its register j.  The registers must be the `wgmma` A
    fragment of that row of pixels: (g, 2t), (g + 8, 2t), (g, 2t + 8), (g + 8,
    2t + 8) and the next channel of each."""
    pix = (rows + 2) * band_w
    vals = torch.arange(pix * 64, dtype=torch.float32).reshape(pix, 64)
    band = torch.empty(pix * 64)
    for p in range(pix):
        for q in range(8):
            band[p * 64 + 8 * (q ^ (p % 8)):p * 64 + 8 * (q ^ (p % 8)) + 8] = vals[p, 8 * q:8 * q + 8]
    dy, dx = divmod(tap, 3)
    for row in (0, rows - 1):          # a warp's tile row
        for s in range(4):
            addr = []
            for lane in range(32):
                p = (row + dy) * band_w + lane % 16 + dx
                addr.append(p * 64 + 8 * ((2 * s + lane // 16) ^ (p % 8)))
            for lane in range(32):
                g, t = divmod(lane, 4)
                regs = [band[addr[8 * j + g] + 2 * t:addr[8 * j + g] + 2 * t + 2] for j in range(4)]
                for j, (m, kk) in enumerate(((g, 0), (g + 8, 0), (g, 8), (g + 8, 8))):
                    p = (row + dy) * band_w + m + dx
                    assert torch.equal(regs[j], vals[p, 16 * s + kk + 2 * t:16 * s + kk + 2 * t + 2])


def test_packed_weights_are_cached_until_the_tensor_changes():
    w = torch.from_numpy(_rand((3, 3, 64, 64), 23))
    before = tf32.pack_count
    first = tf32.packed_weights(w, 64)
    assert tf32.packed_weights(w, 64) is first and tf32.pack_count == before + 1
    w.mul_(2.0)  # in place: the version counter moves, the cache must not serve the old packing
    again = tf32.packed_weights(w, 64)
    assert tf32.pack_count == before + 2
    assert torch.equal(tf32.unpack_conv_weights(again, 64)[0], tf32.split_tf32(w)[0])
    other = w.clone()  # another tensor with the same values is packed on its own
    tf32.packed_weights(other, 64)
    assert tf32.pack_count == before + 3
    # the bf16 layout (the `wgmma` kernels' swizzled tiles) and its adjoint are cached apart
    sw = tf32.packed_weights(w, 64, dtype=torch.bfloat16)
    adj = tf32.packed_weights(w, 64, flip=True, dtype=torch.bfloat16)
    assert sw.shape == adj.shape == (1, 1, 9, 64, 64) and not torch.equal(sw, adj)
    assert tf32.packed_weights(w, 64, dtype=torch.bfloat16) is sw
    assert tf32.pack_count == before + 5


# ---------------------------------------------------------------------------
# (d) the tiled vgg_slice1 backward
# ---------------------------------------------------------------------------


_JAX_DX = {}


def _jax_slice1_dx(h, w):
    """The JAX package's vgg_slice1 gradient (interpret mode), once per size."""
    if (h, w) not in _JAX_DX:
        x, w1, b1, w2, b2, cot = _slice_inputs(h, w)
        with pltpu.force_tpu_interpret_mode():
            _, vjp = jax.vjp(jslice.vgg_slice1, *[jnp.asarray(a) for a in (x, w1, b1, w2, b2)])
            _JAX_DX[(h, w)] = np.asarray(vjp(jnp.asarray(cot))[0])
    return _JAX_DX[(h, w)]


def _slice_inputs(h, w):
    return (_rand((2, h, w, 3), 30), _rand((3, 3, 3, 64), 31, scale=np.sqrt(2.0 / 27)),
            _rand((64,), 32, scale=0.1), _rand((3, 3, 64, 64), 33, scale=np.sqrt(2.0 / 576)),
            _rand((64,), 34, scale=0.1), _rand((2, h, w, 64), 35))


@pytest.mark.parametrize("h,w,tile", [(13, 22, 14), (13, 22, 6), (16, 16, 14), (16, 16, 5)])
def test_tiled_slice1_backward_matches_autograd_and_jax(h, w, tile):
    x, w1, b1, w2, b2, cot = _slice_inputs(h, w)
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = [torch.from_numpy(a) for a in (w1, b1, w2, b2)]
    y = vgg_slice_cuda.vgg_slice1_plain(tx, *tw)
    (want,) = torch.autograd.grad(y, tx, torch.from_numpy(cot))
    got = vgg_slice_cuda.vgg_slice1_backward_tiled(
        torch.from_numpy(cot), y.detach(), tx.detach(), tw[0], tw[1], tw[2], tile)
    # float32 sums over 576 terms in another order: 1e-4 of the scale, as for the kernels
    tol = 1e-4 * max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= tol
    np.testing.assert_allclose(got.numpy(), _jax_slice1_dx(h, w), atol=tol)


# ---------------------------------------------------------------------------
# (e) operation, byte and bound counts at the main path's shapes
# ---------------------------------------------------------------------------


def test_conv3x3_counts_at_the_main_path():
    per_image = [round(c["flops"] / 1e9, 2) for _, c in roofline.main_path("conv3x3_relu", 1)]
    assert per_image == [4.83, 4.83, 4.83, 1.21]
    assert round(roofline.conv3x3_step_flops(16) / 1e9) == 889
    c128 = roofline.conv3x3(1, 128, 128, 128)
    assert c128["bound_by"] == "operations"
    assert c128["bytes"] == 4 * (2 * 128 * 128 * 128 + 9 * 128 * 128 + 128)
    # the step's bound: three TF32 passes on the tensor cores, 5.4 ms
    assert abs(3 * roofline.conv3x3_step_flops(16) / roofline.PEAK_TF32 * 1e3 - 5.39) < 0.01
    assert abs(roofline.conv3x3_step_flops(16) / roofline.PEAK_F32 * 1e3 - 13.3) < 0.05


@pytest.mark.parametrize("name,flops_g,mbytes,by", [
    ("blur4", 0.4918, 123.97, "bytes"),
    # fused with the ToRGB add since the redesign: 9 flops an output, rgb read once
    pytest.param("upblur4", 0.0023587, 2.3587, "bytes", id="upblur4-0.0020966-1.3104-bytes"),
    ("upblur4_adj", 0.0020966, 1.3104, "bytes"),
    ("conv3x3_relu", 15.70, 52.24, "operations"),
    ("vgg_slice1_fwd", 5.06, 17.72, "operations"),
    ("vgg_slice1_bwd", 5.28, 35.28, "operations"),
])
def test_kernel_counts_per_image(name, flops_g, mbytes, by):
    cases = roofline.main_path(name, 1)
    flops = sum(c["flops"] for _, c in cases)
    nbytes = sum(c["bytes"] for _, c in cases)
    assert flops / 1e9 == pytest.approx(flops_g, rel=5e-3)
    assert nbytes / 1e6 == pytest.approx(mbytes, rel=5e-3)
    assert max(cases, key=lambda sc: sc[1]["bound_ms"])[1]["bound_by"] == by
    for _, c in cases:
        t_ops = c["flops"] / (roofline.PEAK_F32 if "blur4" in name else roofline.CONV_RATE)
        assert c["bound_ms"] == pytest.approx(1e3 * max(t_ops, c["bytes"] / roofline.PEAK_BYTES))
    assert set(roofline.LAUNCHES_PER_STEP) == {"blur4", "upblur4", "upblur4_adj", "conv3x3_relu",
                                               "vgg_slice1_fwd", "vgg_slice1_bwd", "lpips_head_fwd", "lpips_head_bwd"}
    # the bf16 variants: the same operations, half the bytes, the FIRs at the float32
    # CUDA-core rate (they sum in float), the products at the dense bf16 tensor-core rate
    for (_, c), (_, b) in zip(cases, roofline.main_path(name, 1, "bfloat16")):
        assert b["flops"] == c["flops"] and b["bytes"] == c["bytes"] / 2
        t_ops = b["flops"] / (roofline.PEAK_F32 if "blur4" in name else roofline.PEAK_BF16)
        assert b["bound_ms"] == pytest.approx(1e3 * max(t_ops, b["bytes"] / roofline.PEAK_BYTES))
    # a bf16 step launches as a float32 one, but for the ToRGB skip chain: once each way
    want = 1 if name in ("upblur4", "upblur4_adj") else roofline.LAUNCHES_PER_STEP[name]
    assert roofline.step_launches("bfloat16")[name + "_bf16"] == want
