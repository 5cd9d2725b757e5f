"""Data-parallel GAN training over the "data" axis of a mesh (the reference
package's ``parallel/train.py``).

The semantics are the global batch's, as GSPMD keeps them in the reference:

- the TrainState (G, D, EMA, both Adam states) is replicated;
- every rank draws the global batch of a step from (seed, step) and keeps
  its rows (``models.stylegan2.stddev_rows``).  Where the batch's
  minibatch-stddev groups split whole over the ranks, each rank holds whole
  groups, and the discriminator's batch statistics are the global batch's
  without a collective.  Otherwise each rank holds a contiguous block of
  rows, and the discriminator gathers the rows over "data" at its stddev
  layer (``parallel.mesh.gather_rows``; its backward sums the cotangents, so
  R1's gradient in a rank's reals includes every rank's logits);
- each rank's losses are means over its rows; the gradients are averaged
  over "data" before Adam (the R1 term with them), so every rank takes the
  global batch's step and the state stays equal on every rank.

The absolute step index keys the draws, so ``--snapshot`` / ``--resume``
compose with the mesh unchanged.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..config import ModelConfig
from ..models.stylegan2 import stddev_rows
from ..training.gan import TrainConfig, TrainState, run_steps
from .mesh import Mesh, replicate


def place_train_state(mesh: Mesh, state: TrainState) -> TrainState:
    """Replicate the whole TrainState across the mesh (in place)."""
    replicate(mesh, [state.g_params, state.d_params, state.g_ema, state.g_opt["mu"], state.g_opt["nu"],
                     state.d_opt["mu"], state.d_opt["nu"]])
    return state


def batch_rows(mesh: Mesh, batch: int) -> torch.Tensor:
    """This rank's rows of a global training batch: whole minibatch-stddev
    groups where they split over "data", else its contiguous block."""
    return stddev_rows(batch, mesh.shape["data"], mesh.index("data"))


def make_mesh_chunk_runners(mesh: Mesh, mcfg: ModelConfig, tcfg: TrainConfig):
    """``(run_chunk, run_chunk_data)`` for data-parallel training.

    ``run_chunk(state, seed, length)`` takes ``length`` synthetic steps;
    ``run_chunk_data(state, seed, reals)`` one step for each batch of a
    [length, batch, S, S, 3] stack of this rank's rows (``shard_reals``).
    Both return the global batch's metrics of every step."""
    if tcfg.batch % mesh.shape["data"] != 0:
        raise ValueError(f"batch {tcfg.batch} not divisible by data axis {mesh.shape['data']}")

    def run_chunk(state: TrainState, seed: int, length: int):
        return run_steps(state, seed, length, mcfg, tcfg, mesh=mesh)

    def run_chunk_data(state: TrainState, seed: int, reals: Sequence[torch.Tensor]):
        return run_steps(state, seed, len(reals), mcfg, tcfg, reals=list(reals), mesh=mesh)

    return run_chunk, run_chunk_data


def shard_reals(mesh: Mesh, reals) -> torch.Tensor:
    """This rank's rows of a [length, batch, S, S, 3] stack of global batches."""
    reals = torch.as_tensor(reals)
    return reals[:, batch_rows(mesh, reals.shape[1])]

