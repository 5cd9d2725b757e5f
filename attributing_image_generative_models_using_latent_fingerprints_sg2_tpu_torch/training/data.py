"""Procedural synthetic images for self-contained GAN training.

Counterpart of the reference package's ``training/data.py``: a gradient
background and anisotropic Gaussian blobs (``sharp``: also hard-edged
rotated rectangles painted over and an oriented stripe patch), squashed by
tanh into [-1, 1].  Each scene is split into a factor **draw** (small
tensors from an explicit ``torch.Generator`` on the CPU) and a **render**
(the image from the factors, on any device), so a test can render the JAX
package's drawn factors and compare images.

The rank-limited draw (``latent_dim > 0``) drives all 35 factors through
``tanh(P @ eps)`` with a fixed projection P.  The port draws P from a torch
generator seeded with 0x5EED; the JAX package draws it from
``PRNGKey(0x5EED)``, so the two rank-d distributions differ in P (their
rank-d property is the same).
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from ..utils.device import resolve_device

N_BLOBS = 3
N_RECTS = 2

# factor count of the smooth scene: c0/c1 colors (6) + gradient direction (2)
# + blob pos (6) + scale (6) + angle (3) + color (9) + amp (3)
_FACTOR_DIM = 35
_PROJ_SEED = 0x5EED

Factors = Dict[str, torch.Tensor]


def _uniform(g: torch.Generator, shape, lo: float, hi: float) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=g)


def draw_smooth_factors(generator: torch.Generator, batch: int) -> Factors:
    """The smooth scene's factors for ``batch`` images (each [batch, ...])."""
    g, k = generator, N_BLOBS
    return {
        "c0": _uniform(g, (batch, 3), -0.8, 0.8), "c1": _uniform(g, (batch, 3), -0.8, 0.8),
        "gdir": torch.randn((batch, 2), generator=g),
        "pos": _uniform(g, (batch, k, 2), -0.7, 0.7), "scale": _uniform(g, (batch, k, 2), 0.08, 0.45),
        "ang": _uniform(g, (batch, k), 0.0, math.pi), "col": _uniform(g, (batch, k, 3), -1.0, 1.0),
        "amp": _uniform(g, (batch, k), 0.6, 1.4),
    }


def draw_sharp_factors(generator: torch.Generator, batch: int) -> Factors:
    """The rectangles' and the stripe patch's factors of the sharp scene."""
    g, r = generator, N_RECTS
    return {
        "rpos": _uniform(g, (batch, r, 2), -0.6, 0.6), "rhalf": _uniform(g, (batch, r, 2), 0.1, 0.4),
        "rang": _uniform(g, (batch, r), 0.0, math.pi), "rcol": _uniform(g, (batch, r, 3), -1.0, 1.0),
        "spos": _uniform(g, (batch, 2), -0.5, 0.5), "sang": _uniform(g, (batch,), 0.0, math.pi),
        "freq": _uniform(g, (batch,), 4.0, 10.0) * math.pi, "scol": _uniform(g, (batch, 3), -1.0, 1.0),
    }


def lowdim_factors(generator: torch.Generator, batch: int, latent_dim: int) -> torch.Tensor:
    """[batch, 35] factor vectors in (-1, 1): tanh(P @ eps) with eps drawn from
    ``generator`` and P a FIXED [35, latent_dim] projection, so the pre-tanh
    population is exactly rank ``latent_dim``."""
    proj = torch.randn((_FACTOR_DIM, latent_dim), generator=torch.Generator().manual_seed(_PROJ_SEED))
    eps = torch.randn((batch, latent_dim), generator=generator)
    return torch.tanh(eps @ (proj / math.sqrt(float(latent_dim))).T)


def smooth_factors_from_z(z: torch.Tensor) -> Factors:
    """Map [batch, 35] vectors in (-1, 1) onto the smooth scene's factors, each
    slot into the range the full draw takes it from."""
    u = z * 0.5 + 0.5
    b, k = z.shape[0], N_BLOBS
    c01 = (-0.8 + u[:, 0:6] * 1.6).reshape(b, 2, 3)
    return {
        "c0": c01[:, 0], "c1": c01[:, 1], "gdir": z[:, 6:8],
        "pos": (-0.7 + u[:, 8:14] * 1.4).reshape(b, k, 2),
        "scale": (0.08 + u[:, 14:20] * 0.37).reshape(b, k, 2),
        "ang": u[:, 20:23] * math.pi, "col": z[:, 23:32].reshape(b, k, 3),
        "amp": 0.6 + u[:, 32:35] * 0.8,
    }


def _grid(size: int, device):
    lin = torch.linspace(-1.0, 1.0, size, device=device)
    return torch.meshgrid(lin, lin, indexing="ij")


def _rotated(yy, xx, pos, ang):
    """Coordinates (u, v) [B, K, S, S] of the grid in the frames at ``pos``
    [B, K, 2] rotated by ``ang`` [B, K]."""
    ca, sa = torch.cos(ang)[..., None, None], torch.sin(ang)[..., None, None]
    dy = yy - pos[..., 0, None, None]
    dx = xx - pos[..., 1, None, None]
    return ca * dy + sa * dx, -sa * dy + ca * dx


def render(f: Factors, size: int, sharp: bool = False) -> torch.Tensor:
    """[B, size, size, 3] images in [-1, 1] from factors (on their device)."""
    yy, xx = _grid(size, f["c0"].device)
    gdir = f["gdir"] / (torch.linalg.norm(f["gdir"], dim=-1, keepdim=True) + 1e-6)
    t = ((yy * gdir[:, 0, None, None] + xx * gdir[:, 1, None, None]) * 0.5 + 0.5)[..., None]
    img = f["c0"][:, None, None] * (1.0 - t) + f["c1"][:, None, None] * t
    u, v = _rotated(yy, xx, f["pos"], f["ang"])
    g = torch.exp(-0.5 * ((u / f["scale"][..., 0, None, None]) ** 2 + (v / f["scale"][..., 1, None, None]) ** 2))
    img = img + torch.einsum("bkij,bkc->bijc", g * f["amp"][..., None, None], f["col"])
    if not sharp:
        return torch.tanh(img)

    # rectangles: steep-sigmoid membership (edge ~1.5 px), painted over what is below
    edge = 1.5 * (2.0 / size)
    ru, rv = _rotated(yy, xx, f["rpos"], f["rang"])
    inside = (torch.sigmoid((f["rhalf"][..., 0, None, None] - ru.abs()) / edge)
              * torch.sigmoid((f["rhalf"][..., 1, None, None] - rv.abs()) / edge))  # [B, R, S, S]
    for r in range(N_RECTS):
        m = inside[:, r, ..., None]
        img = img * (1.0 - m) + f["rcol"][:, r, None, None] * m
    # one oriented stripe patch under a Gaussian window
    sdy = yy - f["spos"][:, 0, None, None]
    sdx = xx - f["spos"][:, 1, None, None]
    proj = torch.cos(f["sang"])[:, None, None] * sdy + torch.sin(f["sang"])[:, None, None] * sdx
    win = torch.exp(-0.5 * (sdy ** 2 + sdx ** 2) / (0.25 ** 2))
    stripes = torch.sin(f["freq"][:, None, None] * proj) * win
    return torch.tanh(img + 0.5 * stripes[..., None] * f["scol"][:, None, None])


def sample_batch(generator: torch.Generator, batch: int, size: int, sharp: bool = False,
                 latent_dim: int = 0, device="cuda") -> torch.Tensor:
    """[batch, size, size, 3] float32 images in [-1, 1], NHWC: factors drawn
    from ``generator`` on the CPU, rendered on ``device`` (the card unless the
    caller asks for the CPU; without CUDA it raises).  ``latent_dim > 0``
    takes the rank-limited smooth draw; ``sharp`` applies to the full draw."""
    device = resolve_device(device)
    if latent_dim > 0:
        if sharp:
            raise ValueError("sharp data variant has no lowdim mode")
        f = smooth_factors_from_z(lowdim_factors(generator, batch, latent_dim))
    else:
        f = draw_smooth_factors(generator, batch)
        if sharp:
            f.update(draw_sharp_factors(generator, batch))
    return render({k: v.to(device) for k, v in f.items()}, size, sharp)
