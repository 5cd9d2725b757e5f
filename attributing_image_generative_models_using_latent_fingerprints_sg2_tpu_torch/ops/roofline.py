"""Operation and byte counts of the port's kernels, the least time an H100
could take for them (the bound ``chip_smoke.py`` prints beside every measured
time), and the launches a solve step and a training step make.

Counts come from shapes alone: useful floating-point operations of the
function (a multiply-add is two), and the bytes it must move (each input read
once, each output written once, 4 bytes an element in float32 and 2 in
bfloat16).  The bound is the larger of bytes over the memory rate and
operations over the peak rate of their kind:

- ``fir``   depthwise FIR arithmetic: the float32 CUDA-core rate, in both
            dtypes (the bf16 kernels sum in float);
- ``conv``  matrix-product arithmetic: in float32 the better of the CUDA-core
            rate and the tensor cores' TF32 rate taken three times (the split
            that keeps float32 accuracy, ``ops/tf32.py``); in bfloat16 the
            tensor cores' dense bf16 rate.

Peaks are NVIDIA's published H100 SXM figures (dense, 700 W).
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

from ..models.stylegan2 import channel_map
from .upfirdn2d_cuda import adj_chain_split

PEAK_F32 = 67e12        # FLOP/s, CUDA cores
PEAK_TF32 = 495e12      # FLOP/s, tensor cores
PEAK_BF16 = 989e12      # FLOP/s, tensor cores, dense
PEAK_BYTES = 3.35e12    # B/s, HBM3
CONV_RATE = max(PEAK_F32, PEAK_TF32 / 3)  # float32-accurate matrix product

# The main path at ``img_size`` (StyleGAN2 config-f's channel map, LPIPS-VGG16 on the
# image as it is): (C, H) of every launch of one solve step's forward.


def blur4_shapes(img_size: int = 256) -> Tuple[Tuple[int, int], ...]:
    """(C, H) of the upsample convs' blurs, r = 8 .. img_size: output H of the
    forward (input H + 1, pads (1, 1)) = input H of its adjoint (pads (2, 2))."""
    chans = channel_map()
    return tuple((chans[1 << k], 1 << k) for k in range(3, int(math.log2(img_size)) + 1))


def upblur4_shapes(img_size: int = 256) -> Tuple[int, ...]:
    """Input H of the ToRGB skip upsamples, 4 .. img_size / 2 (C = 3)."""
    return tuple(1 << k for k in range(2, int(math.log2(img_size))))


def conv3x3_shapes(img_size: int = 256) -> Tuple[Tuple[int, int, int], ...]:
    """LPIPS-VGG16's square convs: (C, H, launches per forward) at img_size / 2
    .. img_size / 16; the backward's dx repeats each launch."""
    return ((128, img_size // 2, 1), (256, img_size // 4, 2), (512, img_size // 8, 2), (512, img_size // 16, 3))


def chain_levels(img_size: int = 256) -> int:
    """Levels of the ToRGB skip chain: one an upsample block, log2(img_size) - 2."""
    return int(math.log2(img_size)) - 2


BLUR4_SHAPES = blur4_shapes()
UPBLUR4_SHAPES = upblur4_shapes()
CONV3X3_SHAPES = conv3x3_shapes()
SLICE1_H = 256  # VGG slice 1 runs on the image
BF16_SUFFIX = "_bf16"  # the name of a kernel's bfloat16 variant is its own + this


def step_launches(dtype: str = "float32", img_size: int = 256, remat: bool = False,
                  remat_lpips: bool = False) -> Dict[str, int]:
    """Launches of one solve step in ``dtype`` ("float32" | "bfloat16") at
    ``img_size``, by the name of the kernel variant that runs them.  A blur4
    an upsample block forward and one in the backward; the skip chain a
    fused ``upblur4`` a level each way in float32, and in bf16 one launch
    forward and the cascade backward (``1 + adj_chain_split``: its widest
    levels go alone first).  ``remat`` re-runs each block's forward blur4 in
    the backward, ``remat_lpips`` LPIPS's forward kernels."""
    n = chain_levels(img_size)
    fwd_convs = sum(k for _, _, k in conv3x3_shapes(img_size))
    launches = {"blur4": (3 if remat else 2) * n, "upblur4": n, "upblur4_adj": n,
                "conv3x3_relu": (3 if remat_lpips else 2) * fwd_convs,
                "vgg_slice1_fwd": 2 if remat_lpips else 1, "vgg_slice1_bwd": 1}
    if dtype != "bfloat16":
        return launches
    # in bf16 the ToRGB skip chain is one launch each way (ops/upfirdn2d_cuda.py::upblur4_chain)
    launches.update(upblur4=1, upblur4_adj=1 + adj_chain_split(4, 4, 3, n))
    return {k + BF16_SUFFIX: v for k, v in launches.items()}


LAUNCHES_PER_STEP = step_launches()

# The 256px discriminator: (C, input size r) of its res blocks, each with two
# blurs on its input width: pads (2, 2) before the 3x3 stride-2 conv (out r + 1)
# and (1, 1) before the 1x1 stride-2 skip (out r - 1).
DISC_BLUR_SHAPES = ((128, 256), (256, 128), (512, 64), (512, 32), (512, 16), (512, 8))
# The quality studies' discriminator (64 px, channel_max 128), the perceptual backbone of
# ``losses/disc_percept.py``: the same two blurs a block.
STUDY_DISC_BLUR_SHAPES = ((128, 64), (128, 32), (128, 16), (128, 8))


def train_launches(img_size: int, r1: bool) -> Dict[str, int]:
    """Kernel launches of one training step (``training/gan.py``) at
    ``img_size``, with n = log2(img_size) - 2 upsample blocks in G and as many
    res blocks (2n blurs) in D.  blur4: G's forward twice (n each), D's forward
    three times (real and fake for D, fake for G) and its backward three times
    (2n each), G's backward (n); R1 adds the reals' input gradient and its
    backward (2n each; the reals' forward is shared).  upblur4: G's forward
    twice; upblur4_adj: G's backward."""
    n = int(math.log2(img_size)) - 2
    return {"blur4": 3 * n + 12 * n + (4 * n if r1 else 0), "upblur4": 2 * n, "upblur4_adj": n,
            "conv3x3_relu": 0, "vgg_slice1_fwd": 0, "vgg_slice1_bwd": 0}


def _counts(flops: float, elems: float, kind: str, dtype: str = "float32") -> Dict[str, object]:
    """Bound of ``flops`` operations of ``kind`` on ``elems`` elements moved in ``dtype``."""
    if kind == "fir":
        rate = PEAK_F32
    else:
        rate = PEAK_BF16 if dtype == "bfloat16" else CONV_RATE
    nbytes = elems * (2 if dtype == "bfloat16" else 4)
    t_ops, t_bytes = flops / rate, nbytes / PEAK_BYTES
    return {"flops": flops, "bytes": nbytes, "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def blur4(n: int, c: int, oh: int, ow: int, pads: Tuple[int, int] = (1, 1),
          dtype: str = "float32") -> Dict[str, object]:
    """4x4 FIR with ``pads`` per axis, so the input is (oh + 3 - p0 - p1) x
    (ow + 3 - p0 - p1): (1, 1) is the forward (in = out + 1), (2, 2) its adjoint
    (in = out - 1).  16 taps an output, taps that meet the padding included."""
    grow = 3 - pads[0] - pads[1]
    return _counts(2.0 * 16 * n * oh * ow * c, 1.0 * n * c * ((oh + grow) * (ow + grow) + oh * ow), "fir", dtype)


def upblur4(n: int, c: int, h: int, w: int, fused: bool = False, dtype: str = "float32") -> Dict[str, object]:
    """up=2 4x4 FIR: 4 of the 16 taps meet a non-zero sample for every output.
    ``fused``: ``rgb + upblur4(x)``, one more add an output and ``rgb`` read once."""
    outs = 4.0 * n * h * w * c
    return _counts((2.0 * 4 + fused) * outs, outs / 4 + outs * (1 + fused), "fir", dtype)


def upblur4_adj(n: int, c: int, h: int, w: int, dtype: str = "float32") -> Dict[str, object]:
    """upblur4's adjoint, (2h x 2w) -> (h x w): 16 taps for every element of the smaller side."""
    return _counts(2.0 * 16 * n * h * w * c, 1.0 * n * c * (4 * h * w + h * w), "fir", dtype)


def _pyramid(n: int, c: int, h0: int, levels) -> float:
    """Elements of the square levels ``levels`` of a pyramid from h0 x h0, doubling a level."""
    return float(sum(n * c * (h0 << k) ** 2 for k in levels))


def upblur4_chain(n: int, c: int, h0: int, levels: int, dtype: str = "float32") -> Dict[str, object]:
    """The ToRGB skip chain in one launch, t_k at (h0 2^k)^2 for k = 0 .. levels:
    reads every t_k once and writes rgb_L once (the intermediate rgb_k never
    reach memory); 9 flops an output of every level above 0, as upblur4 fused."""
    return _counts(9.0 * _pyramid(n, c, h0, range(1, levels + 1)),
                   _pyramid(n, c, h0, range(levels + 1)) + _pyramid(n, c, h0, [levels]), "fir", dtype)


def upblur4_adj_chain(n: int, c: int, h0: int, levels: int, dtype: str = "float32") -> Dict[str, object]:
    """The cotangent cascade in one launch: reads g = g_L once, writes g_0 ..
    g_{L-1} once; 16 taps for every element written."""
    outs = _pyramid(n, c, h0, range(levels))
    return _counts(2.0 * 16 * outs, _pyramid(n, c, h0, [levels]) + outs, "fir", dtype)


def conv3x3(n: int, h: int, w: int, c: int, dtype: str = "float32") -> Dict[str, object]:
    """Square 3x3 conv (+ bias + ReLU): x and y once, the weights and bias once."""
    return _counts(2.0 * 9 * c * c * n * h * w, 2.0 * n * h * w * c + 9 * c * c + c, "conv", dtype)


def slice1_fwd(n: int, h: int, w: int, dtype: str = "float32") -> Dict[str, object]:
    """conv 3 -> 64 + conv 64 -> 64; reads x, writes a2."""
    flops = 2.0 * 9 * (3 * 64 + 64 * 64) * n * h * w
    return _counts(flops, 1.0 * n * h * w * (3 + 64) + 9 * 64 * (3 + 64) + 128, "conv", dtype)


def slice1_bwd(n: int, h: int, w: int, dtype: str = "float32") -> Dict[str, object]:
    """conv_T 64 -> 64, conv1 recomputed for its sign, conv_T 64 -> 3; reads g, a2, x, writes dx."""
    flops = 2.0 * 9 * (64 * 64 + 2 * 3 * 64) * n * h * w
    return _counts(flops, 1.0 * n * h * w * (64 + 64 + 3 + 3) + 9 * 64 * (3 + 64) + 64, "conv", dtype)


def main_path(name: str, n: int, dtype: str = "float32",
              img_size: int = 256) -> Sequence[Tuple[str, Dict[str, object]]]:
    """(shape label, counts) of every distinct launch shape of kernel ``name``
    on the main path at ``img_size`` at batch ``n`` in ``dtype``."""
    if name == "blur4":
        return [(f"C{c}_H{h}", blur4(n, c, h, h, dtype=dtype)) for c, h in blur4_shapes(img_size)]
    if name == "blur4_adj":  # the backward's launches of blur4: H -> H + 1
        return [(f"C{c}_H{h}_adj", blur4(n, c, h + 1, h + 1, (2, 2), dtype)) for c, h in blur4_shapes(img_size)]
    if name in ("blur4_disc", "blur4_disc_study"):  # the discriminator's blurs and (``_adj``) their adjoints
        out = []
        for c, r in DISC_BLUR_SHAPES if name == "blur4_disc" else STUDY_DISC_BLUR_SHAPES:
            out += [(f"D_C{c}_R{r}_p22", blur4(n, c, r + 1, r + 1, (2, 2), dtype)),
                    (f"D_C{c}_R{r}_p11", blur4(n, c, r - 1, r - 1, (1, 1), dtype)),
                    (f"D_C{c}_R{r}_p22_adj", blur4(n, c, r, r, (1, 1), dtype)),
                    (f"D_C{c}_R{r}_p11_adj", blur4(n, c, r, r, (2, 2), dtype))]
        return out
    if name == "upblur4":  # fused with the ToRGB add, as the main path launches it
        return [(f"C3_H{h}", upblur4(n, 3, h, h, fused=True, dtype=dtype)) for h in upblur4_shapes(img_size)]
    if name == "upblur4_adj":
        return [(f"C3_H{h}", upblur4_adj(n, 3, h, h, dtype)) for h in upblur4_shapes(img_size)]
    if name in ("upblur4_chain", "upblur4_adj_chain"):  # the whole chain in one launch
        h0, levels = 4, chain_levels(img_size)
        fn = upblur4_chain if name == "upblur4_chain" else upblur4_adj_chain
        return [(f"C3_H{h0}-H{h0 << levels}", fn(n, 3, h0, levels, dtype))]
    if name == "conv3x3_relu":
        return [(f"C{c}_H{h}", conv3x3(n, h, h, c, dtype)) for c, h, _ in conv3x3_shapes(img_size)]
    if name == "vgg_slice1_fwd":
        return [(f"C3_H{img_size}", slice1_fwd(n, img_size, img_size, dtype))]
    if name == "vgg_slice1_bwd":
        return [(f"C3_H{img_size}", slice1_bwd(n, img_size, img_size, dtype))]
    raise KeyError(name)


def conv3x3_step_flops(chains: int, img_size: int = 256) -> float:
    """Useful flops of all conv3x3_relu launches of one solve step (forward + dx)."""
    return 2.0 * sum(k * conv3x3(chains, h, h, c)["flops"] for c, h, k in conv3x3_shapes(img_size))
