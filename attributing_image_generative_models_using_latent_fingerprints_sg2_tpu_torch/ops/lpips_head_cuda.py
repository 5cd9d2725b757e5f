"""The solver's LPIPS distance head (``csrc/lpips_head.cu``): one launch each way.

``d = mean_hw sum_c lin_c (normalize(f) - t)^2`` per leading index of the raw
feature ``f`` [..., h, w, C] against the cached normalized target ``t``
(broadcast over the leading dims, [S, 1, h, w, C] on the solver's path), and
its hand-derived backward to ``f`` (``t`` and ``lin`` are constants).  The
JAX package leaves this head to XLA, which fuses ``losses/lpips.py``'s
``_fused_slice_distance`` into one pass each way; written out in PyTorch it is
some 25 passes over the feature map, mostly float32 temporaries.

The plain versions below are that chain as ``losses/lpips.py`` has always
computed it: the CPU path, and the tests' yardstick for the kernels.  A CUDA
tensor goes to the kernel of its dtype (``lpips_head_fwd`` / ``_bwd``, and
``*_bf16``) or raises.  The kernels round where the plain chain rounds (norm,
squares and sums in float32, the normalized feature and the difference in f's
dtype); only their sums run in another order.  Features that are not
channel-contiguous (AlexNet's and SqueezeNet's permuted NCHW views) are made
contiguous first; a float32 ``f`` against a bf16 ``t`` (BigGAN's bf16 mode,
whose LPIPS stays float32) takes ``t`` in float32, which is exact.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Tuple

import torch

from ._cuda import FLOAT, INT, PTR, Kernel, by_dtype, check_cuda_operands, register

LONG = ctypes.c_int64
THREADS = 256           # threads a block of csrc/lpips_head.cu
CHAINS = 64             # chains a block walks for one tile of pixels
TARGET_BLOCKS = 2048    # blocks a launch aims at, all samples and chain chunks together
MAX_VECTORS = 8         # 16-byte vectors (or scalars) of a pixel one lane holds

LPIPS_HEAD_FWD = register(Kernel(
    "lpips_head_fwd", "fp_lpips_head_fwd_f32", [PTR] * 6 + [INT] * 9 + [LONG] * 2 + [FLOAT],
    source="csrc/lpips_head.cu",
    replaces="attributing_image_generative_models_using_latent_fingerprints_sg2_tpu/losses/lpips.py:353",
))
LPIPS_HEAD_BWD = register(Kernel(
    "lpips_head_bwd", "fp_lpips_head_bwd_f32", [PTR] * 5 + [INT] * 9 + [LONG] * 2 + [FLOAT] * 2,
    source=LPIPS_HEAD_FWD.source, replaces=LPIPS_HEAD_FWD.replaces,
))
LPIPS_HEAD_FWD_BF16 = register(Kernel(
    "lpips_head_fwd_bf16", "fp_lpips_head_fwd_bf16", LPIPS_HEAD_FWD.argtypes[:-1], source=LPIPS_HEAD_FWD.source,
    replaces=LPIPS_HEAD_FWD.replaces))
LPIPS_HEAD_BWD_BF16 = register(Kernel(
    "lpips_head_bwd_bf16", "fp_lpips_head_bwd_bf16", LPIPS_HEAD_BWD.argtypes[:-1], source=LPIPS_HEAD_FWD.source,
    replaces=LPIPS_HEAD_FWD.replaces))


def lpips_head_plain_forward(f: torch.Tensor, t: torch.Tensor, lin: torch.Tensor,
                             eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(d, norm): the distance [...] in float32 and the channel norm [..., h, w, 1]."""
    f32 = f.float()
    norm = torch.sqrt(torch.sum(f32 * f32, dim=-1, keepdim=True))
    fn = (f32 / (norm + eps)).to(f.dtype)
    d = torch.mean(torch.sum((fn - t).float() ** 2 * lin, dim=-1), dim=(-2, -1))
    return d, norm


def lpips_head_plain_backward(f: torch.Tensor, t: torch.Tensor, lin: torch.Tensor, norm: torch.Tensor,
                              g: torch.Tensor, eps: float) -> torch.Tensor:
    """df in f's dtype from the forward's norm and the cotangent g of d."""
    f32 = f.float()
    denom = norm + eps
    e = ((f32 / denom).to(f.dtype) - t).float()
    hw = f.shape[-3] * f.shape[-2]
    u = e * (lin * (2.0 / hw)) * g[..., None, None, None].float()
    s = torch.sum(u * f32, dim=-1, keepdim=True)
    df = u / denom - f32 * (s / (norm * denom * denom))
    return df.to(f.dtype)


def head_geometry(samples: int, chains: int, pixels: int, c: int, vec: int) -> Dict[str, int]:
    """The launch of csrc/lpips_head.cu for ``samples`` x ``chains`` maps of
    ``pixels`` x ``c``, read ``vec`` elements a vector: ``lanes`` a pixel (the
    largest power of two up to 32 not above the vectors a pixel has), ``kvec``
    vectors a lane, and ``blocks`` blocks a (sample, chunk of 64 chains), each
    over ``pix_per_block`` pixels, whole tiles of 8 warps x 32 / lanes pixels,
    about ``TARGET_BLOCKS`` blocks in all.  Shapes alone decide it, so the
    forward's fixed-order sums are the same on every run."""
    nvec = c // vec
    lanes = min(32, 1 << (nvec.bit_length() - 1))
    kvec = next((k for k in (1, 2, 4, MAX_VECTORS) if k * lanes >= nvec), None)
    if kvec is None:
        raise ValueError(f"lpips_head: C={c} exceeds what a warp holds ({32 * MAX_VECTORS} vectors of {vec})")
    per_tile = (THREADS // 32) * (32 // lanes)
    tiles = -(-pixels // per_tile)
    per_block = max(1, -(-tiles * samples * -(-chains // CHAINS) // TARGET_BLOCKS))
    return {"vec": vec, "lanes": lanes, "kvec": kvec, "blocks": -(-tiles // per_block),
            "pix_per_block": per_block * per_tile}


def _operands(f: torch.Tensor, t: torch.Tensor, lin: torch.Tensor):
    """f as [S, N, P, C] contiguous, t broadcast to it with its (s, n) strides,
    lin as float32, the vector width and the launch geometry."""
    if t.dtype != f.dtype and f.dtype == torch.float32 and t.dtype == torch.bfloat16:
        t = t.float()
    f = f.contiguous()
    dtype = check_cuda_operands("lpips_head", f)
    if t.dtype != dtype or t.device != f.device:
        raise TypeError(f"lpips_head: t in {t.dtype} on {t.device} against f in {dtype} on {f.device}")
    h, w, c = f.shape[-3:]
    lead = tuple(f.shape[:-3])
    n = lead[-1] if lead else 1
    s = math.prod(lead[:-1]) if lead else 1
    if tuple(t.shape[-3:]) == (h, w, c) and t.stride()[-3:] != (w * c, c, 1):
        t = t.contiguous()
    te = t.expand(f.shape).reshape(s, n, h, w, c)
    if te.stride()[-3:] != (w * c, c, 1):
        te = te.contiguous()
    t_s, t_n = (te.stride(0) if s > 1 else 0), (te.stride(1) if n > 1 else 0)
    lin = lin.float().contiguous()
    if tuple(lin.shape) != (c,) or lin.device != f.device:
        raise ValueError(f"lpips_head: lin {tuple(lin.shape)} on {lin.device} for C={c} on {f.device}")
    wide = 16 // f.element_size()
    aligned = all(p % 16 == 0 for p in (f.data_ptr(), te.data_ptr())) and t_s % wide == 0 and t_n % wide == 0
    vec = wide if c % wide == 0 and aligned else 1
    gm = head_geometry(s, n, h * w, c, vec)
    return dtype, f, te, lin, (s, n, h * w, c), (t_s, t_n), gm


_COUNTERS: Dict[Tuple[int, int], torch.Tensor] = {}


def _counter(device: torch.device, samples: int) -> torch.Tensor:
    """The forward's integer counters, one a sample: zeroed once per device and
    stream and left zeroed by every launch (the last block of a sample resets
    its own), so a launch on that stream needs no fill before it.  Called with
    ``device`` current, so that the key is the stream the launch takes."""
    key = (device.index, torch.cuda.current_stream().cuda_stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < samples:
        buf = _COUNTERS[key] = torch.zeros(max(samples, 64), dtype=torch.int32, device=device)
    return buf


def _geometry_args(gm: Dict[str, int]):
    return gm["vec"], gm["lanes"], gm["kvec"], gm["blocks"], gm["pix_per_block"]


def lpips_head_forward(f: torch.Tensor, t: torch.Tensor, lin: torch.Tensor, eps: float) -> torch.Tensor:
    """d [...] (float32) of CUDA features f [..., h, w, C], one launch on f's
    device and its current stream."""
    dtype, f, te, lin, (s, n, p, c), (t_s, t_n), gm = _operands(f, t, lin)
    with torch.cuda.device(f.device):
        partial = torch.empty(s * n * gm["blocks"], dtype=torch.float32, device=f.device)
        d = torch.empty((s, n), dtype=torch.float32, device=f.device)
        by_dtype(dtype, LPIPS_HEAD_FWD, LPIPS_HEAD_FWD_BF16)(
            f.data_ptr(), te.data_ptr(), lin.data_ptr(), partial.data_ptr(), _counter(f.device, s).data_ptr(),
            d.data_ptr(), s, n, p, c, *_geometry_args(gm), t_s, t_n, eps)
    return d.reshape(f.shape[:-3])


def lpips_head_backward(f: torch.Tensor, t: torch.Tensor, lin: torch.Tensor, g: torch.Tensor,
                        eps: float) -> torch.Tensor:
    """df (f's shape and dtype) for the cotangent g [...] of d, one launch on
    f's device; the norm is recomputed from f."""
    dtype, f, te, lin, (s, n, p, c), (t_s, t_n), gm = _operands(f, t, lin)
    g = g.float().reshape(s * n).contiguous()
    df = torch.empty_like(f)
    with torch.cuda.device(f.device):
        by_dtype(dtype, LPIPS_HEAD_BWD, LPIPS_HEAD_BWD_BF16)(
            f.data_ptr(), te.data_ptr(), lin.data_ptr(), g.data_ptr(), df.data_ptr(), s, n, p, c,
            *_geometry_args(gm), t_s, t_n, eps, 2.0 / p)
    return df
