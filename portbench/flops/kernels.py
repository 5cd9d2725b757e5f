"""Frozen copy of the operation and byte counts of the port's six hand-written
kernels (the program's ``ops/roofline.py`` at the time this benchmark was
defined), for per-kernel rooflines named by kernel.

A multiply-add is two operations; each input is read once and each output
written once, 4 bytes an element in float32 and 2 in bfloat16.  The bound is
the larger of bytes over the memory rate and operations over the rate of
their kind: ``fir`` (depthwise FIR) the float32 CUDA-core rate in both
dtypes, ``conv`` the peak of the dtype (``peaks.PEAK_FLOPS``).
"""

from __future__ import annotations

from typing import Dict, Tuple

from .peaks import PEAK_BYTES, PEAK_FLOPS

PEAK_FIR = 67e12  # FLOP/s, float32 CUDA cores


def _counts(flops: float, elems: float, kind: str, dtype: str = "float32") -> Dict[str, object]:
    rate = PEAK_FIR if kind == "fir" else PEAK_FLOPS[dtype]
    nbytes = elems * (2 if dtype == "bfloat16" else 4)
    t_ops, t_bytes = flops / rate, nbytes / PEAK_BYTES
    return {"flops": flops, "bytes": nbytes, "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def blur4(n: int, c: int, oh: int, ow: int, pads: Tuple[int, int] = (1, 1), dtype: str = "float32"):
    """4x4 FIR, pads per axis: 16 taps an output."""
    grow = 3 - pads[0] - pads[1]
    return _counts(2.0 * 16 * n * oh * ow * c, 1.0 * n * c * ((oh + grow) * (ow + grow) + oh * ow), "fir", dtype)


def upblur4(n: int, c: int, h: int, w: int, fused: bool = False, dtype: str = "float32"):
    """up=2 4x4 FIR: 4 of 16 taps meet a non-zero sample; ``fused`` adds rgb."""
    outs = 4.0 * n * h * w * c
    return _counts((2.0 * 4 + fused) * outs, outs / 4 + outs * (1 + fused), "fir", dtype)


def upblur4_adj(n: int, c: int, h: int, w: int, dtype: str = "float32"):
    """upblur4's adjoint, (2h x 2w) -> (h x w): 16 taps an element of the smaller side."""
    return _counts(2.0 * 16 * n * h * w * c, 1.0 * n * c * (4 * h * w + h * w), "fir", dtype)


def _pyramid(n: int, c: int, h0: int, levels) -> float:
    return float(sum(n * c * (h0 << k) ** 2 for k in levels))


def upblur4_chain(n: int, c: int, h0: int, levels: int, dtype: str = "float32"):
    """The ToRGB skip chain in one launch: every t_k read once, rgb_L written once."""
    return _counts(9.0 * _pyramid(n, c, h0, range(1, levels + 1)),
                   _pyramid(n, c, h0, range(levels + 1)) + _pyramid(n, c, h0, [levels]), "fir", dtype)


def upblur4_adj_chain(n: int, c: int, h0: int, levels: int, dtype: str = "float32"):
    """The cotangent cascade in one launch: g_L read once, g_0 .. g_{L-1} written once."""
    outs = _pyramid(n, c, h0, range(levels))
    return _counts(2.0 * 16 * outs, _pyramid(n, c, h0, [levels]) + outs, "fir", dtype)


def conv3x3(n: int, h: int, w: int, c: int, dtype: str = "float32"):
    """Square 3x3 conv + bias + ReLU: x and y once, weights and bias once."""
    return _counts(2.0 * 9 * c * c * n * h * w, 2.0 * n * h * w * c + 9 * c * c + c, "conv", dtype)


def slice1_fwd(n: int, h: int, w: int, dtype: str = "float32"):
    """conv 3 -> 64 + conv 64 -> 64; reads x, writes a2."""
    flops = 2.0 * 9 * (3 * 64 + 64 * 64) * n * h * w
    return _counts(flops, 1.0 * n * h * w * (3 + 64) + 9 * 64 * (3 + 64) + 128, "conv", dtype)


def slice1_bwd(n: int, h: int, w: int, dtype: str = "float32"):
    """conv_T 64 -> 64, conv1 recomputed for its sign, conv_T 64 -> 3."""
    flops = 2.0 * 9 * (64 * 64 + 2 * 3 * 64) * n * h * w
    return _counts(flops, 1.0 * n * h * w * (64 + 64 + 3 + 3) + 9 * 64 * (3 + 64) + 64, "conv", dtype)
