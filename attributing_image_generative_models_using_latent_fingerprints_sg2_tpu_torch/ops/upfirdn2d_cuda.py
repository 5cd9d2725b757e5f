"""The 4-tap FIR kernels of the synthesis network (``csrc/upfirdn2d.cu``).

Counterpart of the reference's ``ops/upfirdn2d_pallas.py``:

- ``blur4``:   up=down=1 separable 4x4 FIR with pads (p0, p1) per axis, the
               post-transpose blur of every upsample styled conv;
- ``upblur4``: up=2, pad (2, 1) separable 4x4 FIR, the ToRGB skip upsample;
               ``upblur4_add(rgb, x, k)`` is the same kernel with the add it
               feeds fused in (``rgb + upblur4(x)``), and its backward is one
               launch of the adjoint kernel ``upblur4_adj`` (the reference
               computes that adjoint outside Pallas);
- ``upblur4_chain(ts, k)``: the whole ToRGB skip chain rgb_0 = t_0, rgb_k =
               t_k + upblur4(rgb_{k-1}).  In bf16 on the card it is ONE launch
               of ``upblur4_bf16`` (``levels`` = L) and its backward one launch
               of ``upblur4_adj_bf16`` (the cotangents g_{k-1} = adj(g_k) of
               every level); in float32 it is L ``upblur4_add`` launches.

Each public function runs its plain PyTorch version on a CPU tensor and the
CUDA kernel on a CUDA tensor: float32, or bfloat16 through the kernels' bf16
variants (``*_bf16``), else it raises.  A bf16 tensor stays bf16 end to end;
the kernels and their plain versions sum in float32 and round each output to
bf16 once, where the reference's TPU kernels round.  On a CUDA tensor
every backward is itself an autograd Function over these three kernels, so
the ops are differentiable to any order (training's R1 penalty takes a
gradient of a gradient through the discriminator's blurs).  Taps are the
per-axis kernel *including* its gain, as in the reference.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ._cuda import FLOAT, INT, PTR, Kernel, by_dtype, check_cuda_operands, register, widen

BLUR4 = register(Kernel(
    "blur4", "fp_blur4_f32", [PTR, PTR] + [INT] * 8 + [FLOAT] * 8,
    source="csrc/upfirdn2d.cu",
    replaces="attributing_image_generative_models_using_latent_fingerprints_sg2_tpu/ops/upfirdn2d_pallas.py:127",
))
UPBLUR4 = register(Kernel(
    "upblur4", "fp_upblur4_f32", [PTR, PTR, PTR] + [INT] * 4 + [FLOAT] * 4,
    source="csrc/upfirdn2d.cu",
    replaces="attributing_image_generative_models_using_latent_fingerprints_sg2_tpu/ops/upfirdn2d_pallas.py:216",
))
UPBLUR4_ADJ = register(Kernel(
    "upblur4_adj", "fp_upblur4_adj_f32", [PTR, PTR] + [INT] * 4 + [FLOAT] * 4,
    source="csrc/upfirdn2d.cu",
    replaces="attributing_image_generative_models_using_latent_fingerprints_sg2_tpu/ops/upfirdn2d_pallas.py:235",
))
BLUR4_BF16 = register(Kernel(
    "blur4_bf16", "fp_blur4_bf16", BLUR4.argtypes[:-1], source=BLUR4.source, replaces=BLUR4.replaces))
# the bf16 pair takes a whole skip chain: a host array of level pointers and the number of levels
UPBLUR4_BF16 = register(Kernel(
    "upblur4_bf16", "fp_upblur4_bf16", [PTR, PTR] + [INT] * 5 + [FLOAT] * 4, source=UPBLUR4.source,
    replaces=UPBLUR4.replaces))
UPBLUR4_ADJ_BF16 = register(Kernel(
    "upblur4_adj_bf16", "fp_upblur4_adj_bf16", [PTR, PTR] + [INT] * 5 + [FLOAT] * 4, source=UPBLUR4_ADJ.source,
    replaces=UPBLUR4_ADJ.replaces))

# Mirrors of csrc/upfirdn2d.cu's chain constants: the forward's tile of the top level,
# and the cascade's strips, cluster and shared-memory limit (adj_cascade_layout).
CHAIN_MAX_LEVELS = 11
CHAIN_TILE = (32, 64)
ADJ_MIN_ROWS = 8
ADJ_MAX_CLUSTER = 8
CHAIN_SMEM_MAX = 200 * 1024


def depthwise_correlate(
    x: torch.Tensor, k2d: torch.Tensor, pads: Tuple[int, int, int, int], stride=1
) -> torch.Tensor:
    """NHWC depthwise correlation with one 2-D kernel; pads = (y0, y1, x0, x1) >= 0,
    stride an int or (y, x)."""
    c = x.shape[-1]
    t = F.pad(x.permute(0, 3, 1, 2), (pads[2], pads[3], pads[0], pads[1]))
    w = k2d.to(x.dtype).expand(c, 1, *k2d.shape).contiguous()
    return F.conv2d(t, w, stride=stride, groups=c).permute(0, 2, 3, 1)


def _outer(a: Sequence[float], b: Sequence[float], like: torch.Tensor) -> torch.Tensor:
    return torch.outer(torch.tensor(list(a), dtype=torch.float32),
                       torch.tensor(list(b), dtype=torch.float32)).to(like.device)


# ---------------------------------------------------------------------------
# plain versions: the result in the input's dtype; a bf16 input is widened to
# float32 exactly and its result rounded once, as the kernels do
# ---------------------------------------------------------------------------


def blur4_plain(x, ky, kx, pad_y, pad_x) -> torch.Tensor:
    """upfirdn2d(x, outer(ky, kx), pad=...): correlate with the flipped kernel."""
    k = _outer(tuple(ky)[::-1], tuple(kx)[::-1], x)
    return depthwise_correlate(widen(x), k, (pad_y[0], pad_y[1], pad_x[0], pad_x[1])).to(x.dtype)


def blur4_strips(x, ky, kx, pad_y, pad_x, rows: int = 64, vec: int = 4) -> torch.Tensor:
    """:func:`blur4_plain` computed as the kernel walks it, in plain PyTorch:
    strips of ``rows`` output rows, each reading rows + 3 input rows; per input
    row the 4-tap horizontal sum (taps summed left to right), then the vertical
    sum over a 4-row sliding window (top to bottom); channels in groups of
    ``vec`` with a scalar remainder; zeros outside the input.  For the tests."""
    n, h, w, c = x.shape
    fy, fx = tuple(ky)[::-1], tuple(kx)[::-1]
    oh, ow = h + pad_y[0] + pad_y[1] - 3, w + pad_x[0] + pad_x[1] - 3
    y = x.new_zeros((n, oh, ow, c))
    cmain = c - c % vec
    groups = [slice(c0, c0 + vec) for c0 in range(0, cmain, vec)] + [slice(c0, c0 + 1) for c0 in range(cmain, c)]
    for ch in groups:
        width = ch.stop - ch.start
        for oy0 in range(0, oh, rows):
            for ox in range(ow):
                win = [x.new_zeros((n, width)) for _ in range(4)]
                for r in range(min(rows, oh - oy0) + 3):
                    iy = oy0 - pad_y[0] + r
                    taps = [x[:, iy, ox - pad_x[0] + j, ch]
                            if 0 <= iy < h and 0 <= ox - pad_x[0] + j < w else x.new_zeros((n, width))
                            for j in range(4)]
                    win = win[1:] + [fx[0] * taps[0] + fx[1] * taps[1] + fx[2] * taps[2] + fx[3] * taps[3]]
                    if r >= 3:
                        y[:, oy0 + r - 3, ox, ch] = fy[0] * win[0] + fy[1] * win[1] + fy[2] * win[2] + fy[3] * win[3]
    return y


def _upblur4_wide(x, k) -> torch.Tensor:
    n, h, w, c = x.shape
    u = x.new_zeros((n, 2 * h, 2 * w, c), dtype=torch.promote_types(x.dtype, torch.float32))
    u[:, ::2, ::2] = x
    kf = tuple(k)[::-1]
    return depthwise_correlate(u, _outer(kf, kf, x), (2, 1, 2, 1))


def upblur4_plain(x, k) -> torch.Tensor:
    """upfirdn2d(x, outer(k, k), up=2, pad=(2, 1)): zero-stuff, pad, correlate."""
    return _upblur4_wide(x, k).to(x.dtype)


def upblur4_add_plain(rgb, x, k) -> torch.Tensor:
    """``rgb + upblur4(x, k)``, summed wide and rounded once, as the fused kernel."""
    return (widen(rgb) + _upblur4_wide(x, k)).to(rgb.dtype)


def upblur4_adjoint_plain(g: torch.Tensor, k) -> torch.Tensor:
    """Adjoint of upblur4: down=2 correlation with outer(k, k), pad (1, 1)
    (the reference's ``_upblur4_bwd``)."""
    return depthwise_correlate(widen(g), _outer(k, k, g), (1, 1, 1, 1), stride=2).to(g.dtype)


def upblur4_chain_plain(ts: Sequence[Optional[torch.Tensor]], k) -> torch.Tensor:
    """rgb_L of rgb_0 = t_0, rgb_k = t_k + upblur4(rgb_{k-1}): one
    :func:`upblur4_add_plain` a level, so each rgb_k is rounded once (a
    None t_L: no add at the top)."""
    rgb = ts[0]
    for t in ts[1:]:
        rgb = upblur4_plain(rgb, k) if t is None else upblur4_add_plain(t, rgb, k)
    return rgb


def upblur4_adj_chain_plain(g: torch.Tensor, k, levels: int) -> List[torch.Tensor]:
    """[g_0, ..., g_L] with g_L = g and g_{k-1} = adjoint(g_k), one
    :func:`upblur4_adjoint_plain` a level."""
    gs = [g]
    for _ in range(levels):
        gs.insert(0, upblur4_adjoint_plain(gs[0], k))
    return gs


def chain_span(a: int, b: int, size: int) -> Tuple[int, int]:
    """The rows (or columns) [a', b') of a level of ``size`` that upblur4
    reads for rows [a, b) of the level above it: (i - 1, i) for an even output
    2i, (i, i + 1) for an odd one, within the image."""
    return max(0, (a - 1) >> 1), min(size, (b >> 1) + 1)


def upblur4_chain_tiles(ts: Sequence[Optional[torch.Tensor]], k, tile: Tuple[int, int] = CHAIN_TILE) -> torch.Tensor:
    """:func:`upblur4_chain_plain` computed as ``upblur4_chain_bf16_kernel``
    walks it, in plain PyTorch: tiles of ``tile`` (rows, columns) of the top
    level, each computed upward from level 0 on the regions :func:`chain_span`
    gives, a level's values NaN outside its region (so a region too small
    shows), the taps of each output in the kernel's order (the vertical pair
    first).  No rounding between levels: for the tests, in float64."""
    f = tuple(k)[::-1]
    levels = len(ts) - 1
    n, h0, w0, c = ts[0].shape
    hs, ws = [h0 << i for i in range(levels + 1)], [w0 << i for i in range(levels + 1)]
    y = ts[0].new_full((n, hs[-1], ws[-1], c), float("nan"))
    for y0 in range(0, hs[-1], tile[0]):
        for x0 in range(0, ws[-1], tile[1]):
            rows, cols = [(y0, min(y0 + tile[0], hs[-1]))], [(x0, min(x0 + tile[1], ws[-1]))]
            for lev in range(levels, 0, -1):
                rows.insert(0, chain_span(*rows[0], hs[lev - 1]))
                cols.insert(0, chain_span(*cols[0], ws[lev - 1]))
            lvl = ts[0].new_full((n, h0, w0, c), float("nan"))
            (ra, rb), (ca, cb) = rows[0], cols[0]
            lvl[:, ra:rb, ca:cb] = ts[0][:, ra:rb, ca:cb]
            for lev in range(1, levels + 1):
                (ra, rb), (ca, cb) = rows[lev], cols[lev]
                pad = lvl.new_zeros((n, hs[lev - 1] + 2, ws[lev - 1] + 2, c))
                pad[:, 1:-1, 1:-1] = lvl
                oy, ox = torch.arange(ra, rb), torch.arange(ca, cb)
                r0, c0 = oy // 2 + oy % 2, ox // 2 + ox % 2  # (i - 1 + parity) + 1 for the pad
                fa, fb = (torch.tensor(f, dtype=lvl.dtype)[p] for p in ((oy % 2), (oy % 2) + 2))
                ga, gb = (torch.tensor(f, dtype=lvl.dtype)[p] for p in ((ox % 2), (ox % 2) + 2))
                v = fa[:, None, None] * pad[:, r0] + fb[:, None, None] * pad[:, r0 + 1]
                out = ga[:, None] * v[:, :, c0] + gb[:, None] * v[:, :, c0 + 1]
                if ts[lev] is not None:
                    out = out + ts[lev][:, ra:rb, ca:cb]
                lvl = lvl.new_full((n, hs[lev], ws[lev], c), float("nan"))
                lvl[:, ra:rb, ca:cb] = out
            y[:, y0:y0 + tile[0], x0:x0 + tile[1]] = lvl[:, y0:y0 + tile[0], x0:x0 + tile[1]]
    return y


def adj_cascade_smem(h0: int, w0: int, c: int, levels: int) -> int:
    """Shared-memory bytes of one ``upblur4_adj_bf16`` cascade launch over
    ``levels`` > 1 levels (csrc/upfirdn2d.cu::adj_cascade_layout): region 0
    (the rows of g a block's strip of level L-1 reads, the two rows of L-1
    next to the strip, or L-2 whole for rank 0, whichever is largest), the
    block's strips of L-1 and L-2, L-3 whole, the row table and the mbarrier."""
    align = lambda b: -(-b // 16) * 16  # noqa: E731
    ht, row1 = h0 << (levels - 1), (w0 << (levels - 1)) * c * 2
    cluster = min(ADJ_MAX_CLUSTER, max(1, ht // ADJ_MIN_ROWS))
    tr = 2 * -(-ht // (2 * cluster))
    grows = min(2 * ht, 2 * tr + 2)
    region0 = max(grows * align(2 * row1 + 14), align(2 * row1), align(ht * row1 // 4))
    tab = region0 + align(tr * row1) + align(tr * row1 // 4) + align(ht * row1 // 16)
    return -(-(tab + 4 * grows) // 8) * 8 + 8


def adj_chain_split(h0: int, w0: int, c: int, levels: int) -> int:
    """How many leading (largest) levels of a cotangent cascade go as
    single-level launches first, because the cascade's shared memory could
    not hold its widest strip: 0 up to 256 px at C = 3, 1 at 512 px, 2 at
    1024 px."""
    lead = 0
    while levels - lead > 1 and adj_cascade_smem(h0, w0, c, levels - lead) > CHAIN_SMEM_MAX:
        lead += 1
    return lead


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


def blur4_launch(x, fy, fx, pad_y, pad_x) -> torch.Tensor:
    """Launch with FLIPPED taps fy/fx (correlation taps)."""
    kernel = by_dtype(check_cuda_operands("blur4", x), BLUR4, BLUR4_BF16)
    n, h, w, c = x.shape
    oh = h + pad_y[0] + pad_y[1] - 3
    ow = w + pad_x[0] + pad_x[1] - 3
    if oh <= 0 or ow <= 0:
        raise ValueError(f"blur4: empty output for input {tuple(x.shape)} and pads {pad_y}, {pad_x}")
    y = torch.empty((n, oh, ow, c), device=x.device, dtype=x.dtype)
    kernel(x.data_ptr(), y.data_ptr(), n, h, w, c, oh, ow, pad_y[0], pad_x[0], *fy, *fx)
    return y


class _Blur4(torch.autograd.Function):
    """blur4 with taps ky, kx: one launch forward.  Its adjoint is blur4 again,
    with the taps reversed and pads (3 - p0, 3 - p1), through this Function, so
    the adjoint's own backward is the forward: differentiable to any order
    (the R1 penalty of training differentiates through it twice)."""

    @staticmethod
    def forward(ctx, x, ky, kx, pad_y, pad_x):
        ctx.taps = (ky, kx, pad_y, pad_x)
        return blur4_launch(x.contiguous(), ky[::-1], kx[::-1], pad_y, pad_x)

    @staticmethod
    def backward(ctx, g):
        ky, kx, pad_y, pad_x = ctx.taps
        dx = _Blur4.apply(g, ky[::-1], kx[::-1], (3 - pad_y[0], 3 - pad_y[1]), (3 - pad_x[0], 3 - pad_x[1]))
        return dx, None, None, None, None


def _pointers(tensors: Sequence[Optional[torch.Tensor]]):
    """A host array of the tensors' device pointers (None: a null pointer)."""
    return (ctypes.c_void_p * len(tensors))(*[None if t is None else t.data_ptr() for t in tensors])


def _check_levels(name: str, levels: int) -> None:
    if not 1 <= levels <= CHAIN_MAX_LEVELS:
        raise ValueError(f"{name}: {levels} levels; the kernel takes 1 to {CHAIN_MAX_LEVELS}")


def upblur4_launch(x, k, rgb=None) -> torch.Tensor:
    """upblur4(x) (+ ``rgb`` [N, 2H, 2W, C] when given) with UNFLIPPED taps ``k``
    (in bf16: a one-level launch of the chain kernel)."""
    dtype = check_cuda_operands("upblur4", x, *([] if rgb is None else [rgb]))
    n, h, w, c = x.shape
    y = torch.empty((n, 2 * h, 2 * w, c), device=x.device, dtype=x.dtype)
    if rgb is not None and rgb.shape != y.shape:
        raise ValueError(f"upblur4: rgb {tuple(rgb.shape)} does not match the output {tuple(y.shape)}")
    if dtype == torch.bfloat16:
        ptrs = _pointers([x, rgb])
        UPBLUR4_BF16(ctypes.addressof(ptrs), y.data_ptr(), n, h, w, c, 1, *k[::-1])
    else:
        UPBLUR4(x.data_ptr(), None if rgb is None else rgb.data_ptr(), y.data_ptr(), n, h, w, c, *k[::-1])
    return y


def upblur4_chain_launch(ts: Sequence[Optional[torch.Tensor]], k) -> torch.Tensor:
    """rgb_L of the bf16 skip chain over ``ts`` = [t_0, ..., t_L] (t_k
    [N, H0 2^k, W0 2^k, C]; t_L may be None: no add at the top) in ONE launch
    of ``upblur4_bf16``; UNFLIPPED taps ``k``."""
    levels = len(ts) - 1
    _check_levels("upblur4_chain", levels)
    given = [t for t in ts if t is not None]
    if check_cuda_operands("upblur4_chain", *given) != torch.bfloat16 or ts[0] is None:
        raise TypeError("upblur4_chain: the chain kernel takes bfloat16 levels, t_0 given")
    n, h0, w0, c = ts[0].shape
    for i, t in enumerate(ts):
        if (t is None and i < levels) or (t is not None and t.shape != (n, h0 << i, w0 << i, c)):
            raise ValueError(f"upblur4_chain: level {i} is {None if t is None else tuple(t.shape)}, "
                             f"expected {(n, h0 << i, w0 << i, c)}")
    y = torch.empty((n, h0 << levels, w0 << levels, c), device=ts[0].device, dtype=ts[0].dtype)
    ptrs = _pointers(ts)
    UPBLUR4_BF16(ctypes.addressof(ptrs), y.data_ptr(), n, h0, w0, c, levels, *k[::-1])
    return y


def upblur4_adjoint_launch(g, k) -> torch.Tensor:
    """The adjoint of upblur4 applied to g [N, 2H, 2W, C], UNFLIPPED taps ``k``
    (in bf16: a one-level launch of the cascade kernel)."""
    dtype = check_cuda_operands("upblur4_adj", g)
    n, oh, ow, c = g.shape
    if oh % 2 or ow % 2:
        raise ValueError(f"upblur4_adj: odd cotangent size {tuple(g.shape)}")
    dx = torch.empty((n, oh // 2, ow // 2, c), device=g.device, dtype=g.dtype)
    if dtype == torch.bfloat16:
        ptrs = _pointers([dx])
        UPBLUR4_ADJ_BF16(g.data_ptr(), ctypes.addressof(ptrs), n, oh // 2, ow // 2, c, 1, *k)
    else:
        UPBLUR4_ADJ(g.data_ptr(), dx.data_ptr(), n, oh // 2, ow // 2, c, *k)
    return dx


def upblur4_adj_chain_launch(g: torch.Tensor, k, levels: int) -> List[torch.Tensor]:
    """[g_0, ..., g_{L-1}] of the bf16 cotangent cascade g_{k-1} = adjoint(g_k)
    from g_L = ``g`` [N, H0 2^L, W0 2^L, C], views of one allocation: ONE
    launch of ``upblur4_adj_bf16``, after :func:`adj_chain_split`'s leading
    levels as one-level launches where the cascade's shared memory cannot hold
    them.  UNFLIPPED taps ``k``."""
    _check_levels("upblur4_adj_chain", levels)
    if check_cuda_operands("upblur4_adj_chain", g) != torch.bfloat16:
        raise TypeError("upblur4_adj_chain: the cascade kernel takes bfloat16")
    n, hl, wl, c = g.shape
    if hl % (1 << levels) or wl % (1 << levels):
        raise ValueError(f"upblur4_adj_chain: {tuple(g.shape)} is not a {levels}-level chain's top")
    h0, w0 = hl >> levels, wl >> levels
    views, total, lead = _adj_chain_layout(n, h0, w0, c, levels)
    flat = torch.empty(total, device=g.device, dtype=g.dtype)
    gs = [flat.as_strided(*v) for v in views]
    ptrs = [flat.data_ptr() + 2 * v[2] for v in views] + [g.data_ptr()]
    top = levels
    for _ in range(lead):  # the widest levels alone, top down
        outs = (ctypes.c_void_p * 1)(ptrs[top - 1])
        UPBLUR4_ADJ_BF16(ptrs[top], ctypes.addressof(outs), n, h0 << (top - 1), w0 << (top - 1), c, 1, *k)
        top -= 1
    outs = (ctypes.c_void_p * top)(*ptrs[:top])
    UPBLUR4_ADJ_BF16(ptrs[top], ctypes.addressof(outs), n, h0, w0, c, top, *k)
    return gs


@functools.lru_cache(maxsize=None)
def _adj_chain_layout(n: int, h0: int, w0: int, c: int, levels: int):
    """((shape, stride, offset) of g_0 .. g_{L-1} in one allocation, its size,
    the leading single-level launches) of a cascade."""
    views, off = [], 0
    for i in range(levels):
        h, w = h0 << i, w0 << i
        views.append(((n, h, w, c), (h * w * c, w * c, c, 1), off))
        off += n * h * w * c
    return tuple(views), off, adj_chain_split(h0, w0, c, levels)


class _Upblur4(torch.autograd.Function):
    """upblur4(x) + rgb (rgb may be None): one launch forward, one backward
    (through :class:`_Upblur4Adj`, so it is differentiable again)."""

    @staticmethod
    def forward(ctx, x, rgb, k):
        ctx.k = k
        return upblur4_launch(x.contiguous(), k, None if rgb is None else rgb.contiguous())

    @staticmethod
    def backward(ctx, g):
        dx = _Upblur4Adj.apply(g, ctx.k) if ctx.needs_input_grad[0] else None
        return dx, (g if ctx.needs_input_grad[1] else None), None


class _Upblur4Adj(torch.autograd.Function):
    """upblur4's adjoint: one launch of ``upblur4_adj``; its backward is
    upblur4 without the add."""

    @staticmethod
    def forward(ctx, g, k):
        ctx.k = k
        return upblur4_adjoint_launch(g.contiguous(), k)

    @staticmethod
    def backward(ctx, gg):
        return _Upblur4.apply(gg, None, ctx.k), None


class _Upblur4Chain(torch.autograd.Function):
    """rgb_L of the bf16 skip chain over t_0 .. t_L (t_L may be None): one
    launch forward; its backward is :class:`_Upblur4AdjChain`, one launch for
    the cotangents of t_0 .. t_{L-1}, and the incoming cotangent itself for t_L."""

    @staticmethod
    def forward(ctx, k, *ts):
        ctx.k, ctx.levels, ctx.top = k, len(ts) - 1, ts[-1] is not None
        return upblur4_chain_launch([None if t is None else t.contiguous() for t in ts], k)

    @staticmethod
    def backward(ctx, g):
        return (None, *_Upblur4AdjChain.apply(g, ctx.k, ctx.levels), g if ctx.top else None)


class _Upblur4AdjChain(torch.autograd.Function):
    """g_0 .. g_{L-1} of the bf16 cotangent cascade from g = g_L: one launch
    (:func:`upblur4_adj_chain_launch`).  The map is linear, and its adjoint is
    the chain over the incoming cotangents with no add at the top, through
    :class:`_Upblur4Chain`: differentiable to any order."""

    @staticmethod
    def forward(ctx, g, k, levels):
        ctx.k = k
        return tuple(upblur4_adj_chain_launch(g.contiguous(), k, levels))

    @staticmethod
    def backward(ctx, *gg):
        return _Upblur4Chain.apply(ctx.k, *gg, None), None, None


def blur4(x: torch.Tensor, ky, kx, pad_y, pad_x) -> torch.Tensor:
    """4x4 separable FIR on NHWC, out = H + pad0 + pad1 - 3 per axis."""
    ky, kx = tuple(float(v) for v in ky), tuple(float(v) for v in kx)
    pad_y, pad_x = tuple(int(v) for v in pad_y), tuple(int(v) for v in pad_x)
    if x.device.type == "cpu":
        return blur4_plain(x, ky, kx, pad_y, pad_x)
    return _Blur4.apply(x, ky, kx, pad_y, pad_x)


def upblur4(x: torch.Tensor, k) -> torch.Tensor:
    """upfirdn2d(x, outer(k, k), up=2, pad=(2, 1)) on NHWC, out = 2H x 2W."""
    k = tuple(float(v) for v in k)
    if x.device.type == "cpu":
        return upblur4_plain(x, k)
    return _Upblur4.apply(x, None, k)


def upblur4_add(rgb: torch.Tensor, x: torch.Tensor, k) -> torch.Tensor:
    """``rgb + upblur4(x, k)`` in one pass: the ToRGB skip connection."""
    k = tuple(float(v) for v in k)
    if x.device.type == "cpu":
        return upblur4_add_plain(rgb, x, k)
    return _Upblur4.apply(x, rgb, k)


def upblur4_chain(ts: Sequence[torch.Tensor], k) -> torch.Tensor:
    """rgb_L of the ToRGB skip chain rgb_0 = t_0, rgb_k = t_k + upblur4(rgb_{k-1}, k)
    over ``ts`` = [t_0, ..., t_L], t_k [N, H0 2^k, W0 2^k, C]: the plain chain
    on a CPU tensor, :func:`upblur4_add` a level in float32 on the card, and in
    bf16 one launch each way (:class:`_Upblur4Chain`)."""
    k = tuple(float(v) for v in k)
    if ts[0].device.type == "cpu":
        return upblur4_chain_plain(ts, k)
    if len(ts) == 1 or ts[0].dtype != torch.bfloat16:
        return upblur4_chain_per_level(ts, k)
    return _Upblur4Chain.apply(k, *ts)


def upblur4_chain_per_level(ts: Sequence[torch.Tensor], k) -> torch.Tensor:
    """The skip chain as one fused ``rgb + upblur4`` launch a level, each
    differentiated by its own adjoint launch: the float32 route on the card."""
    rgb = ts[0]
    for t in ts[1:]:
        rgb = _Upblur4.apply(rgb, t, k)
    return rgb
