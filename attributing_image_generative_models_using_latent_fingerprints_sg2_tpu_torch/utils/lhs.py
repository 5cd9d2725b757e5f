"""Centered Latin Hypercube restarts (the reference's ``LatinHypercube(d,
centered=True)``): sample[i, dim] = (perm_dim[i] + 0.5) / n, an independent
permutation of strata per dimension, all drawn in one argsort."""

from __future__ import annotations

import hashlib
from typing import Optional, Union

import torch


def latin_hypercube_batch(batch: int, n: int, d: int,
                          generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """[batch, n, d] independent centered LHS designs in [0, 1)."""
    perms = torch.argsort(torch.rand((batch, d, n), generator=generator), dim=-1)
    return ((perms.float() + 0.5) / n).transpose(1, 2)


def lhs_alpha_init_batch(batch: int, n: int, sigma: torch.Tensor,
                         generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """[batch, n, d] restart initializations scaled to [-sigma, sigma]."""
    s = latin_hypercube_batch(batch, n, sigma.shape[0], generator).to(sigma.device)
    return (2.0 * s - 1.0) * sigma


def fold_in(parent: Union[torch.Generator, int], data: int) -> torch.Generator:
    """A new CPU generator seeded by a fixed hash of ``parent``'s seed (a
    generator's ``initial_seed()``, however much has been drawn from it) and
    ``data``: chunk ``data`` of a run draws the same numbers whether or not the
    chunks before it ran in this process."""
    seed = parent.initial_seed() if isinstance(parent, torch.Generator) else int(parent)
    digest = hashlib.sha256(f"{seed}:{int(data)}".encode()).digest()
    return torch.Generator().manual_seed(int.from_bytes(digest[:8], "little") >> 1)
