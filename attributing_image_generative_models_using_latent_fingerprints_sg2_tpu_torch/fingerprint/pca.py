"""PCA of the generator's latent space, on the device (``torch.linalg.eigh``).

Counterpart of the reference package's ``fingerprint/pca.py`` (StyleGAN2's W
space, BigGAN's truncated noise): components
are eigenvectors of the sample covariance (denominator n-1) ranked by
descending variance, each row's sign fixed so its largest-|.| coordinate is
positive.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..models import biggan as bg
from ..models import stylegan2 as sg2


@dataclasses.dataclass(frozen=True)
class PCABasis:
    pc: torch.Tensor  # [D, D] components as rows, descending variance
    sigma: torch.Tensor  # [D] per-axis standard deviations
    mean: torch.Tensor  # [D] latent mean


def pca_from_samples(samples: torch.Tensor) -> PCABasis:
    """PCA of [N, D] samples via eigh of the covariance."""
    n = samples.shape[0]
    mean = samples.mean(dim=0)
    xc = samples - mean
    cov = (xc.T @ xc) / (n - 1)
    evals, evecs = torch.linalg.eigh(cov)  # ascending
    evals = torch.flip(evals, (0,))
    pc = torch.flip(evecs, (1,)).T.contiguous()
    idx = torch.argmax(pc.abs(), dim=1)
    signs = torch.sign(pc[torch.arange(pc.shape[0], device=pc.device), idx])
    pc = pc * signs[:, None]
    return PCABasis(pc=pc, sigma=torch.sqrt(torch.clamp(evals, min=0.0)), mean=mean)


@torch.no_grad()
def perform_pca(
    mapping_fn: Callable[[torch.Tensor], torch.Tensor],
    n_samples: int = 10000,
    dim: int = 512,
    generator: Optional[torch.Generator] = None,
) -> PCABasis:
    """z ~ N(0, I) [n_samples, dim], drawn on the CPU from ``generator`` and
    handed to ``mapping_fn`` (which moves it where its weights are) -> PCA of
    the latents it returns."""
    return pca_from_samples(mapping_fn(torch.randn((n_samples, dim), generator=generator)))


@torch.no_grad()
def perform_pca_for_params(
    params,
    lr_mlp: float,
    n_samples: int = 10000,
    dim: int = 512,
    generator: Optional[torch.Generator] = None,
    z: Optional[torch.Tensor] = None,
) -> PCABasis:
    """z ~ N(0, I) [n_samples, dim] (or the given ``z``) -> mapping network -> PCA."""
    device = params["input"].device

    def mapping_fn(zs: torch.Tensor) -> torch.Tensor:
        return sg2.mapping_network(params, zs.to(device), lr_mlp)

    if z is None:
        return perform_pca(mapping_fn, n_samples, dim, generator)
    return pca_from_samples(mapping_fn(z))


@torch.no_grad()
def pca_from_truncated_noise(
    truncation: float,
    n_samples: int,
    dim: int = 128,
    *,
    device,
    generator: Optional[torch.Generator] = None,
    z: Optional[torch.Tensor] = None,
) -> PCABasis:
    """BigGAN: PCA of the truncated-normal latents themselves [n_samples, dim]
    (drawn from ``generator``, or the given ``z``)."""
    if z is None:
        z = bg.truncated_noise(n_samples, truncation, dim, generator)
    return pca_from_samples(torch.as_tensor(z, dtype=torch.float32).to(device))
