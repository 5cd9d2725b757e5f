"""Operation and byte counts of the port's five kernels, and the least time
an H100 could take for them (the bound ``chip_smoke.py`` prints beside every
measured time).

Counts come from shapes alone: useful floating-point operations of the
function (a multiply-add is two), and the bytes it must move (each input read
once, each output written once, float32).  The bound is the larger of bytes
over the memory rate and operations over the peak rate of their kind:

- ``fir``   depthwise FIR arithmetic: the float32 CUDA-core rate;
- ``conv``  float32 matrix-product arithmetic: the better of the CUDA-core
            rate and the tensor cores' TF32 rate taken three times (the split
            that keeps float32 accuracy, ``ops/tf32.py``).

Peaks are NVIDIA's published H100 SXM figures (dense, 700 W).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

PEAK_F32 = 67e12        # FLOP/s, CUDA cores
PEAK_TF32 = 495e12      # FLOP/s, tensor cores
PEAK_BYTES = 3.35e12    # B/s, HBM3
CONV_RATE = max(PEAK_F32, PEAK_TF32 / 3)  # float32-accurate matrix product

# The 256px main path: (C, H) of every launch of one solve step's forward.
BLUR4_SHAPES = ((512, 8), (512, 16), (512, 32), (512, 64), (256, 128), (128, 256))  # output H
UPBLUR4_SHAPES = (4, 8, 16, 32, 64, 128)                                             # input H, C = 3
# conv3x3_relu: (C, H, launches per forward); the backward's dx repeats each launch.
CONV3X3_SHAPES = ((128, 128, 1), (256, 64, 2), (512, 32, 2), (512, 16, 3))
SLICE1_H = 256
LAUNCHES_PER_STEP = {"blur4": 12, "upblur4": 6, "conv3x3_relu": 16,
                     "vgg_slice1_fwd": 1, "vgg_slice1_bwd": 1}


def _counts(flops: float, nbytes: float, kind: str) -> Dict[str, object]:
    rate = PEAK_F32 if kind == "fir" else CONV_RATE
    t_ops, t_bytes = flops / rate, nbytes / PEAK_BYTES
    return {"flops": flops, "bytes": nbytes, "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def blur4(n: int, c: int, oh: int, ow: int) -> Dict[str, object]:
    """4x4 FIR, input (oh + 1) x (ow + 1) with pads (1, 1): 16 taps an output."""
    return _counts(2.0 * 16 * n * oh * ow * c, 4.0 * n * c * ((oh + 1) * (ow + 1) + oh * ow), "fir")


def upblur4(n: int, c: int, h: int, w: int) -> Dict[str, object]:
    """up=2 4x4 FIR: 4 of the 16 taps meet a non-zero sample for every output."""
    return _counts(2.0 * 4 * n * 4 * h * w * c, 4.0 * n * c * (h * w + 4 * h * w), "fir")


def conv3x3(n: int, h: int, w: int, c: int) -> Dict[str, object]:
    """Square 3x3 conv (+ bias + ReLU): x and y once, the weights and bias once."""
    return _counts(2.0 * 9 * c * c * n * h * w, 4.0 * (2 * n * h * w * c + 9 * c * c + c), "conv")


def slice1_fwd(n: int, h: int, w: int) -> Dict[str, object]:
    """conv 3 -> 64 + conv 64 -> 64; reads x, writes a2."""
    flops = 2.0 * 9 * (3 * 64 + 64 * 64) * n * h * w
    return _counts(flops, 4.0 * (n * h * w * (3 + 64) + 9 * 64 * (3 + 64) + 128), "conv")


def slice1_bwd(n: int, h: int, w: int) -> Dict[str, object]:
    """conv_T 64 -> 64, conv1 recomputed for its sign, conv_T 64 -> 3; reads g, a2, x, writes dx."""
    flops = 2.0 * 9 * (64 * 64 + 2 * 3 * 64) * n * h * w
    return _counts(flops, 4.0 * (n * h * w * (64 + 64 + 3 + 3) + 9 * 64 * (3 + 64) + 64), "conv")


def main_path(name: str, n: int) -> Sequence[Tuple[str, Dict[str, object]]]:
    """(shape label, counts) of every distinct launch shape of kernel ``name``
    on the 256px main path at batch ``n``."""
    if name == "blur4":
        return [(f"C{c}_H{h}", blur4(n, c, h, h)) for c, h in BLUR4_SHAPES]
    if name == "upblur4":
        return [(f"C3_H{h}", upblur4(n, 3, h, h)) for h in UPBLUR4_SHAPES]
    if name == "conv3x3_relu":
        return [(f"C{c}_H{h}", conv3x3(n, h, h, c)) for c, h, _ in CONV3X3_SHAPES]
    if name == "vgg_slice1_fwd":
        return [(f"C3_H{SLICE1_H}", slice1_fwd(n, SLICE1_H, SLICE1_H))]
    if name == "vgg_slice1_bwd":
        return [(f"C3_H{SLICE1_H}", slice1_bwd(n, SLICE1_H, SLICE1_H))]
    raise KeyError(name)


def conv3x3_step_flops(chains: int) -> float:
    """Useful flops of all conv3x3_relu launches of one solve step (forward + dx)."""
    return 2.0 * sum(k * conv3x3(chains, h, h, c)["flops"] for c, h, k in CONV3X3_SHAPES)
