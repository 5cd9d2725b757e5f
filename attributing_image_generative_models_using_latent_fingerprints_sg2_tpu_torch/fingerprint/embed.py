"""Fingerprint embedding: content and key carriers of the principal basis.

Counterpart of the reference package's ``fingerprint/embed.py``:

    w0 = alpha @ U + mu                  (content)
    wx = w0 + c * (s * k) @ V            (content + key)

with V = pc[shift : shift+key_len], U the remaining rows, s the fixed
per-axis sigma, k in {0,1}^K (or sigmoid-relaxed while solving).
Row-vector convention: latents are [B, D].
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..config import FingerprintConfig
from .pca import PCABasis


@dataclasses.dataclass(frozen=True)
class FingerprintBasis:
    u_cap: torch.Tensor  # [D-K, D] content carrier
    v_cap: torch.Tensor  # [K, D] key carrier
    sigma_rest: torch.Tensor  # [D-K] empirical sigmas of the content axes
    sigma_key: torch.Tensor  # [K] fixed perturbation strengths
    mean: torch.Tensor  # [D]
    max_alpha: torch.Tensor  # [D-K] +3 sigma box
    min_alpha: torch.Tensor  # [D-K] -3 sigma box
    sd_moved: float = 1.0


def build_basis(pca: PCABasis, fp: FingerprintConfig) -> FingerprintBasis:
    """Slice the full PCA basis by (shift, key_len)."""
    k0, k1 = fp.shift, fp.shift + fp.key_len
    sigma_rest = torch.cat([pca.sigma[:k0], pca.sigma[k1:]])
    bound = 3.0 * sigma_rest
    return FingerprintBasis(
        u_cap=torch.cat([pca.pc[:k0], pca.pc[k1:]], dim=0),
        v_cap=pca.pc[k0:k1],
        sigma_rest=sigma_rest,
        sigma_key=torch.full((fp.key_len,), float(fp.sigma), dtype=pca.sigma.dtype,
                             device=pca.sigma.device),
        mean=pca.mean,
        max_alpha=bound,
        min_alpha=-bound,
        sd_moved=float(fp.sd_moved),
    )


def sample_key_bits(key_len: int, batch: int, generator: Optional[torch.Generator],
                    device) -> torch.Tensor:
    """k ~ U{0,1}^K as float [B, K]."""
    return torch.randint(0, 2, (batch, key_len), generator=generator).float().to(device)


def sample_alpha(basis: FingerprintBasis, batch: int,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """alpha ~ sigma_rest * N(0, 1), [B, D-K]."""
    d = basis.sigma_rest.shape[0]
    z = torch.randn((batch, d), generator=generator).to(basis.sigma_rest.device)
    return z * basis.sigma_rest


def content_latent(basis: FingerprintBasis, alpha: torch.Tensor) -> torch.Tensor:
    return alpha @ basis.u_cap + basis.mean


def key_offset(basis: FingerprintBasis, k: torch.Tensor) -> torch.Tensor:
    return basis.sd_moved * (k * basis.sigma_key) @ basis.v_cap


def embed(basis: FingerprintBasis, alpha: torch.Tensor, k: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(w0, wx): content latent and fingerprinted latent."""
    w0 = content_latent(basis, alpha)
    return w0, w0 + key_offset(basis, k)


def project_latent(basis: FingerprintBasis, w: torch.Tensor) -> torch.Tensor:
    """The projection of latents w [B, D] onto the content subspace,
    U^T (U U^T)^-1 U (w - mu), with no mean added back (the reference's
    ``generate_with_latent``; U U^T is I for orthonormal rows, the solve keeps
    non-orthonormal bases exact)."""
    uut = basis.u_cap @ basis.u_cap.T
    coords = torch.linalg.solve(uut, basis.u_cap @ (w - basis.mean).T)
    return (basis.u_cap.T @ coords).T


def alpha_bound_penalty(basis: FingerprintBasis, alpha: torch.Tensor) -> torch.Tensor:
    """Sum of ReLU violations of the +-3 sigma box, per row."""
    over = torch.relu(alpha - basis.max_alpha)
    under = torch.relu(basis.min_alpha - alpha)
    return torch.sum(over + under, dim=-1)


def bit_accuracy(pred_bits: torch.Tensor, true_bits: torch.Tensor) -> torch.Tensor:
    return (pred_bits == true_bits).float().mean(dim=-1)
