"""Attribution and generation over the "data" axis of a mesh (the reference
package's ``parallel/solver.py``).

Each rank solves its rows of the targets with the single-device solver
(``fingerprint.attribute``), and the result is gathered over "data" in
sample order.  Every per-sample restart is an independent Adam chain, so the
only communication is that gather (and the weights' broadcast) --- the
communication floor of this algorithm.  What a single-process run draws for
all S samples (the restart starts, the generation latents) every rank draws
for all S too, from a generator of the same seed, and keeps its rows: a mesh
run solves and renders what the single-process run does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..config import AttributionConfig, ModelConfig
from ..fingerprint import attribute as attr
from ..fingerprint import pipeline as pl
from ..fingerprint.embed import embed, sample_alpha, sample_key_bits
from ..utils.lhs import lhs_alpha_init_batch
from .mesh import Mesh, all_gather_rows, replicate, shard_batch, shard_generator_params


def _gather_result(mesh: Mesh, res: attr.AttributionResult) -> attr.AttributionResult:
    """The global result from every rank's rows: each field gathered over "data"."""
    return attr.AttributionResult(**{
        f.name: None if getattr(res, f.name) is None else all_gather_rows(mesh, getattr(res, f.name))
        for f in dataclasses.fields(res)})


def _replicate_basis(mesh: Mesh, basis):
    tensors = {f.name: getattr(basis, f.name) for f in dataclasses.fields(basis)
               if torch.is_tensor(getattr(basis, f.name))}
    return dataclasses.replace(basis, **replicate(mesh, tensors))


def solve_placed(
    mesh: Mesh,
    gen_params,
    lpips_params,
    basis,
    noise,
    local_targets: torch.Tensor,
    *,
    mcfg: ModelConfig,
    acfg: AttributionConfig,
    shard_model: bool = False,
    **kwargs,
) -> attr.AttributionResult:
    """Replicate the weights on ``mesh`` and solve this rank's rows of the targets.

    Shared core of the single-host path (``attribute_on_mesh``) and the
    multi-host one (``parallel.multihost.attribute_multihost``).  The starts
    are global: ``alpha_init`` / ``key_init`` are [S, n, ...] for all S =
    rows x data samples, or are drawn for all S from ``generator`` as
    ``attribute`` draws them; each rank takes its rows.  Returns the global
    result on every rank."""
    gen_params = shard_generator_params(mesh, gen_params) if shard_model else replicate(mesh, gen_params)
    lpips_params, basis, noise = replicate(mesh, lpips_params), _replicate_basis(mesh, basis), replicate(mesh, noise)
    return solve_rows(mesh, gen_params, lpips_params, basis, noise, local_targets, mcfg=mcfg, acfg=acfg, **kwargs)


def solve_rows(
    mesh: Mesh,
    gen_params,
    lpips_params,
    basis,
    noise,
    local_targets: torch.Tensor,
    *,
    mcfg: ModelConfig,
    acfg: AttributionConfig,
    generator: Optional[torch.Generator] = None,
    n_starts: Optional[int] = None,
    alpha_init: Optional[torch.Tensor] = None,
    key_init: Optional[torch.Tensor] = None,
    **kwargs,
) -> attr.AttributionResult:
    """:func:`solve_placed` with the weights placed already (``place_pipeline``)."""
    n_starts = acfg.n_starts if n_starts is None else n_starts
    s_global = local_targets.shape[0] * mesh.shape["data"]
    if alpha_init is None:
        if generator is None:
            raise ValueError("a mesh solve draws its restarts from an explicit generator (every rank must "
                             "draw the same starts): pass generator= or alpha_init=")
        alpha_init = lhs_alpha_init_batch(s_global, n_starts, basis.sigma_rest, generator)
    if key_init is None:
        key_init = torch.zeros((s_global, n_starts, basis.v_cap.shape[0]))
    res = attr.attribute(gen_params, lpips_params, basis, noise, local_targets, mcfg=mcfg, acfg=acfg,
                         n_starts=n_starts, alpha_init=shard_batch(mesh, torch.as_tensor(alpha_init)),
                         key_init=shard_batch(mesh, torch.as_tensor(key_init)), **kwargs)
    return _gather_result(mesh, res)


def attribute_on_mesh(
    mesh: Mesh,
    gen_params,
    lpips_params,
    basis,
    noise,
    targets: torch.Tensor,
    *,
    mcfg: ModelConfig,
    acfg: AttributionConfig,
    shard_model: bool = False,
    **kwargs,
) -> attr.AttributionResult:
    """Solve all ``targets`` [S, H, W, 3] (equal on every rank) with the sample
    axis sharded over "data": each rank solves its contiguous rows; the
    result is global on every rank.  ``kwargs`` are ``attribute``'s
    (``generator``, ``n_starts``, ``alpha_init`` / ``key_init`` for all S, ...)."""
    data = mesh.shape["data"]
    if targets.shape[0] % data != 0:
        raise ValueError(f"sample count {targets.shape[0]} not divisible by data axis {data}")
    return solve_placed(mesh, gen_params, lpips_params, basis, noise, shard_batch(mesh, targets),
                        mcfg=mcfg, acfg=acfg, shard_model=shard_model, **kwargs)


def place_pipeline(mesh: Mesh, pipe: pl.Pipeline, *, shard_model: bool = False) -> pl.Pipeline:
    """Place a pipeline's tensors on ``mesh`` once: generator weights, basis,
    fixed noise and (where present) LPIPS weights and BigGAN's class one-hot
    replicated (broadcast from the mesh's first rank)."""
    return dataclasses.replace(
        pipe, gen_params=shard_generator_params(mesh, pipe.gen_params) if shard_model
        else replicate(mesh, pipe.gen_params), basis=_replicate_basis(mesh, pipe.basis),
        noise=replicate(mesh, pipe.noise), lpips_params=replicate(mesh, pipe.lpips_params),
        class_onehot=replicate(mesh, pipe.class_onehot))


def synthesize_on_mesh(mesh: Mesh, pipe: pl.Pipeline, w: torch.Tensor) -> torch.Tensor:
    """``pipeline.synthesize`` of all latents ``w`` [B, D] (equal on every
    rank) with the batch sharded over "data": each rank renders its rows, the
    images are gathered."""
    return all_gather_rows(mesh, pl.synthesize(pipe, shard_batch(mesh, w)))


@torch.no_grad()
def generate_on_mesh(mesh: Mesh, pipe: pl.Pipeline, batch: int, generator: torch.Generator):
    """Data-parallel fingerprinted generation.

    The (imgs, w0, wx, bits, alpha) of ``pipeline.generate_fingerprinted``,
    with its draws from ``generator``, but the synthesis --- all of the
    FLOPs --- sharded over "data"; the latent-space math (a few [B, 512]
    products) is computed on every rank.  ``pipe`` should already be placed
    with ``place_pipeline``."""
    data = mesh.shape["data"]
    if batch % data != 0:
        raise ValueError(f"batch {batch} not divisible by data axis {data}")
    alpha = sample_alpha(pipe.basis, batch, generator)
    bits = sample_key_bits(pipe.fpcfg.key_len, batch, generator, pipe.device)
    w0, wx = embed(pipe.basis, alpha, bits)
    return synthesize_on_mesh(mesh, pipe, wx), w0, wx, bits, alpha
