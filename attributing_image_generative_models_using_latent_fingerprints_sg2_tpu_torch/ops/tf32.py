"""The three-pass TF32 split and the weight packing of the tensor-core kernels
(float32: TF32 hi/lo tiles; bfloat16: the 64-channel 128-byte-swizzled tiles
of the bf16 ``wgmma`` kernels).

The tensor cores have no float32 product.  ``csrc/tc_tile.cuh`` therefore
splits both operands, ``a = a_hi + a_lo`` with ``a_hi = tf32(a)`` and
``a_lo = tf32(a - a_hi)``, and sums ``a_lo*b_hi + a_hi*b_lo + a_hi*b_hi`` in
float32; the dropped ``a_lo*b_lo`` is ~2^-22 relative.  The activations are
split in registers by the kernel; the weights are split and packed here, once
per weight tensor (:func:`packed_weights` caches on the tensor's identity and
version), into the image the kernel's shared-memory stages hold.

Everything here is plain PyTorch and runs on any device.  The emulation
(:func:`conv3x3_three_pass`) is for the tests, not for the main path.
"""

from __future__ import annotations

import weakref
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

KC = 32  # input channels per packed chunk: one 128-byte row of float32


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> nearest value with a 10-bit mantissa, ties away from zero
    (PTX ``cvt.rna.tf32.f32``): add half an ulp to the magnitude, mask 13 bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x -> (hi, lo), both TF32-representable, hi + lo == x to ~2^-22 relative."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def flip_io(w_hwio: torch.Tensor) -> torch.Tensor:
    """Adjoint conv weights: spatial flip + swap in/out channels."""
    return torch.flip(w_hwio, (0, 1)).permute(0, 1, 3, 2).contiguous()


def _k_order(device) -> torch.Tensor:
    """Physical channel (within a chunk of 32) at each logical k position of
    the packed row: logical k = 8 s + t + 4 j  <-  channel 8 t + 2 s + j, so
    that the thread with lane % 4 == t finds its fragment values of all four
    k-steps s in 8 consecutive channels."""
    kk = torch.arange(KC, device=device)
    s, r = kk // 8, kk % 8
    return 8 * (r % 4) + 2 * s + r // 4


def _swizzle_index(n_tile: int, device) -> torch.Tensor:
    """Position (in floats) of element [row, k] inside a [n_tile, 32] tile
    stored in the 128-byte swizzle: 16-byte chunk index XOR (row % 8)."""
    row = torch.arange(n_tile, device=device)[:, None]
    k = torch.arange(KC, device=device)[None, :]
    return row * KC + (((k // 4) ^ (row % 8)) * 4 + k % 4)


def pack_conv_weights(w_hwio: torch.Tensor, n_tile: int) -> torch.Tensor:
    """HWIO [3, 3, C_in, C_out] -> [C_out tiles, C_in / 32, 9 taps, 2 (hi, lo),
    n_tile, 32] float32: K-major rows (one out-channel each, padded with zero
    rows up to a multiple of ``n_tile``), k permuted by :func:`_k_order`,
    every [n_tile, 32] tile stored in the 128-byte swizzle."""
    _, _, cin, cout = w_hwio.shape
    if cin % KC or n_tile % 8:
        raise ValueError(f"pack_conv_weights: C_in {cin} % {KC} or n_tile {n_tile} % 8 is not 0")
    dev = w_hwio.device
    n_tiles = -(-cout // n_tile)
    w = w_hwio.reshape(9, cin, cout).to(torch.float32)
    w = F.pad(w, (0, n_tiles * n_tile - cout))
    # [tap, chunk, k (physical), tile, n] -> logical k order -> [tile, chunk, tap, n, k]
    w = w.reshape(9, cin // KC, KC, n_tiles, n_tile)[:, :, _k_order(dev)]
    w = w.permute(3, 1, 0, 4, 2)
    hi, lo = split_tf32(w.contiguous())
    tiles = torch.stack((hi, lo), dim=3).reshape(-1, n_tile * KC)
    out = torch.empty_like(tiles)
    out[:, _swizzle_index(n_tile, dev).reshape(-1)] = tiles
    return out.reshape(n_tiles, cin // KC, 9, 2, n_tile, KC)


KC_SW128 = 64  # input channels per chunk of the bf16 `wgmma` packing: one 128-byte row of bf16


def swizzle128_index(n_tile: int, device=None) -> torch.Tensor:
    """Position (in bf16 elements) of element [row, k] inside a [n_tile, 64]
    tile stored in the 128-byte swizzle: 16-byte chunk index XOR (row % 8)."""
    row = torch.arange(n_tile, device=device)[:, None]
    k = torch.arange(KC_SW128, device=device)[None, :]
    return row * KC_SW128 + (((k // 8) ^ (row % 8)) * 8 + k % 8)


def pack_conv_weights_sw128(w_hwio: torch.Tensor, n_tile: int) -> torch.Tensor:
    """HWIO [3, 3, C_in, C_out] -> [C_out tiles, C_in / 64, 9 taps, n_tile, 64]
    bfloat16 (rounded to nearest even): K-major rows (one out-channel each,
    zero rows up to a multiple of ``n_tile``), channels in their own order,
    every [n_tile, 64] tile in the 128-byte swizzle, so that one (chunk, tap)
    stage is the image a ``wgmma`` descriptor reads (``csrc/tc_tile.cuh``,
    bf16 ``wgmma`` route)."""
    _, _, cin, cout = w_hwio.shape
    if cin % KC_SW128 or n_tile % 8:
        raise ValueError(f"pack_conv_weights_sw128: C_in {cin} % {KC_SW128} or n_tile {n_tile} % 8 is not 0")
    n_tiles = -(-cout // n_tile)
    w = F.pad(w_hwio.reshape(9, cin, cout).to(torch.float32), (0, n_tiles * n_tile - cout))
    # [tap, chunk, k, tile, n] -> [tile, chunk, tap, n, k]
    w = w.reshape(9, cin // KC_SW128, KC_SW128, n_tiles, n_tile).permute(3, 1, 0, 4, 2)
    tiles = w.to(torch.bfloat16).reshape(-1, n_tile * KC_SW128)
    out = torch.empty_like(tiles)
    out[:, swizzle128_index(n_tile, w.device).reshape(-1)] = tiles
    return out.reshape(n_tiles, cin // KC_SW128, 9, n_tile, KC_SW128)


def unpack_conv_weights_sw128(packed: torch.Tensor, cout: int) -> torch.Tensor:
    """Inverse of :func:`pack_conv_weights_sw128`: HWIO [3, 3, C_in, cout] bf16."""
    n_tiles, nchunks, _, n_tile, _ = packed.shape
    tiles = packed.reshape(-1, n_tile * KC_SW128)[:, swizzle128_index(n_tile, packed.device).reshape(-1)]
    w = tiles.reshape(n_tiles, nchunks, 9, n_tile, KC_SW128)
    # [tile, chunk, tap, n, k] -> [tap, chunk, k, tile, n]
    w = w.permute(2, 1, 4, 0, 3).reshape(3, 3, nchunks * KC_SW128, n_tiles * n_tile)
    return w[..., :cout].contiguous()


def unpack_conv_weights(packed: torch.Tensor, cout: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`pack_conv_weights`: (hi, lo) as HWIO [3, 3, C_in, cout]."""
    n_tiles, nchunks, _, _, n_tile, _ = packed.shape
    dev = packed.device
    tiles = packed.reshape(-1, n_tile * KC)[:, _swizzle_index(n_tile, dev).reshape(-1)]
    w = tiles.reshape(n_tiles, nchunks, 9, 2, n_tile, KC)
    inv = torch.argsort(_k_order(dev))
    w = w[..., inv]  # physical k order
    # [tile, chunk, tap, hl, n, k] -> [hl, tap, chunk, k, tile, n]
    w = w.permute(3, 2, 1, 5, 0, 4).reshape(2, 3, 3, nchunks * KC, n_tiles * n_tile)[..., :cout]
    return w[0].contiguous(), w[1].contiguous()


_PACKED: Dict[Tuple[int, int, bool, torch.dtype], Tuple[weakref.ref, int, torch.Tensor]] = {}
pack_count = 0  # packings done so far: a run can show that none happens per call


def packed_weights(w_hwio: torch.Tensor, n_tile: int, flip: bool = False,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Packed (and, with ``flip``, adjoint) weights of ``w_hwio`` for the kernel
    of ``dtype`` (float32: :func:`pack_conv_weights`; bfloat16: the swizzled
    64-channel tiles of the bf16 ``wgmma`` kernels,
    :func:`pack_conv_weights_sw128`), computed on first use and again only
    after the tensor was changed in place (its ``_version`` moved) or another
    tensor took its place."""
    global pack_count
    key = (id(w_hwio), n_tile, flip, dtype)
    hit = _PACKED.get(key)
    if hit is not None and hit[0]() is w_hwio and hit[1] == w_hwio._version:
        return hit[2]
    for k in [k for k, v in _PACKED.items() if v[0]() is None]:
        del _PACKED[k]
    with torch.no_grad():
        w = w_hwio.detach()
        pack = pack_conv_weights_sw128 if dtype == torch.bfloat16 else pack_conv_weights
        packed = pack(flip_io(w) if flip else w.contiguous(), n_tile)
    pack_count += 1
    _PACKED[key] = (weakref.ref(w_hwio), w_hwio._version, packed)
    return packed


def conv3x3_three_pass(x: torch.Tensor, w_hwio: torch.Tensor, bias=None) -> torch.Tensor:
    """Emulation of the kernel's arithmetic: conv3x3 (stride 1, pad 1, NHWC /
    HWIO) as the three products of the TF32 split, each summed in float32."""

    def conv(a, b):
        return F.conv2d(a.permute(0, 3, 1, 2), b.permute(3, 2, 0, 1), None, padding=1)

    x_hi, x_lo = split_tf32(x)
    w_hi, w_lo = split_tf32(w_hwio)
    y = conv(x_lo, w_hi) + conv(x_hi, w_lo) + conv(x_hi, w_hi)
    if bias is not None:
        y = y + bias[None, :, None, None]
    return y.permute(0, 2, 3, 1)
