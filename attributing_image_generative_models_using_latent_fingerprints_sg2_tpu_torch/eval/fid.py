"""Frechet Inception Distance, and the Frechet distance over the trained
discriminator's pooled features.

Counterpart of the reference package's ``eval/fid.py``:

    FID(mu1, S1, mu2, S2) = |mu1 - mu2|^2 + tr(S1 + S2 - 2 (S1 S2)^(1/2)).

Features are computed on the card in chunks under ``torch.no_grad()``
(Inception pool3, 2048-d: ``eval/inception.py``); their statistics
accumulate on the host in float64, exactly; the one matrix square root a
distance takes runs on the host (``scipy.linalg.sqrtm``), once per
comparison.  :func:`frechet_distance` keeps the reference's arithmetic: the
eps-regularised retry on a non-finite root and the real part of a complex
one (with a few samples the covariances are singular).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from .inception import inception_features, preprocess


@dataclasses.dataclass
class FeatureStats:
    """Streaming mean / covariance accumulator (host float64, exact)."""

    n: int = 0
    sum: Optional[np.ndarray] = None
    outer: Optional[np.ndarray] = None

    def update(self, feats: np.ndarray) -> None:
        feats = np.asarray(feats, np.float64)
        if self.sum is None:
            d = feats.shape[1]
            self.sum = np.zeros(d)
            self.outer = np.zeros((d, d))
        self.n += feats.shape[0]
        self.sum += feats.sum(0)
        self.outer += feats.T @ feats

    def finalize(self) -> Tuple[np.ndarray, np.ndarray]:
        mu = self.sum / self.n
        cov = (self.outer - self.n * np.outer(mu, mu)) / (self.n - 1)
        return mu, cov


@torch.no_grad()
def _chunked(fn: Callable[[torch.Tensor], torch.Tensor], images: torch.Tensor, batch: int) -> np.ndarray:
    return np.concatenate([fn(images[i:i + batch]).float().cpu().numpy()
                           for i in range(0, images.shape[0], batch)], 0)


def compute_features(params, images: torch.Tensor, batch: int = 16) -> np.ndarray:
    """[-1, 1] NHWC images on the params' device -> [N, 2048] pool3 features,
    ``batch`` images at a time."""
    return _chunked(lambda x: inception_features(params, preprocess(x)), images, batch)


def frechet_distance(mu1: np.ndarray, cov1: np.ndarray, mu2: np.ndarray, cov2: np.ndarray,
                     eps: float = 1e-6) -> float:
    """The Frechet distance of two Gaussians, the square root on the host."""
    import scipy.linalg

    diff = mu1 - mu2
    # sqrtm(A) without ``disp``: the same root, and the one call form of every scipy
    covmean = scipy.linalg.sqrtm(cov1 @ cov2)
    if not np.isfinite(covmean).all():
        offset = np.eye(cov1.shape[0]) * eps
        covmean = scipy.linalg.sqrtm((cov1 + offset) @ (cov2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(cov1) + np.trace(cov2) - 2 * np.trace(covmean))


def _distance(features: Callable[[torch.Tensor], np.ndarray], images1: torch.Tensor,
              images2: torch.Tensor) -> float:
    s1, s2 = FeatureStats(), FeatureStats()
    s1.update(features(images1))
    s2.update(features(images2))
    return frechet_distance(*s1.finalize(), *s2.finalize())


def fid_between(params, images1: torch.Tensor, images2: torch.Tensor, batch: int = 16) -> float:
    """FID between two image populations (Inception params ``params``)."""
    return _distance(lambda x: compute_features(params, x, batch), images1, images2)


def disc_pooled_features(d_params: Any, images: torch.Tensor, batch: int = 16) -> np.ndarray:
    """[-1, 1] NHWC images -> [N, sum(C_i)]: the trained discriminator's
    feature maps (``losses/disc_percept.py``'s taps) averaged over space in
    float32 and concatenated.  A trained backbone makes this distance
    meaningful where random Inception weights are only ordinal."""
    from ..losses.disc_percept import disc_features

    def pooled(x):
        return torch.cat([f.float().mean(dim=(1, 2)) for f in disc_features(d_params, x)], dim=-1)

    return _chunked(pooled, images, batch)


def fid_between_disc(d_params: Any, images1: torch.Tensor, images2: torch.Tensor, batch: int = 16) -> float:
    """Frechet distance over the discriminator's pooled features."""
    return _distance(lambda x: disc_pooled_features(d_params, x, batch), images1, images2)
