"""Joining the process group, and attribution, generation and training over
all of its ranks (the reference package's ``parallel/multihost.py``).

JAX runs one process per host over that host's devices; PyTorch runs one
process per device, so a single-host run on several cards and a run over
several hosts are the same thing here: ranks of one ``torch.distributed``
process group, on the grid of ``parallel.mesh``.  This module joins the
group; ``mesh.py`` builds on it.  Every rank runs the same program (SPMD)
and holds its rows of the sample axis; weights and the basis are equal on
every rank (same checkpoint or seed, then a broadcast).

Typical use (one process per device, started by torchrun):

    from ...parallel import multihost as mh
    device = mh.initialize(device="cuda")   # reads torchrun's MASTER_ADDR etc.
    mesh = mh.global_mesh()
    res = mh.attribute_multihost(
        mesh, gen_params, lpips_params, basis, noise,
        local_targets,                    # THIS rank's samples [S_local, H, W, 3]
        generator=torch.Generator().manual_seed(seed), mcfg=mcfg, acfg=acfg,
    )                                     # the global result, on every rank

The backend is chosen before the group starts, from the device and the
world: nccl when every rank of the host has a card of its own, gloo on the
CPU or when ranks share a card (nccl refuses two ranks on one device).  It is
never switched after a failure.
"""

from __future__ import annotations

import datetime
import os
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import AttributionConfig, ModelConfig
from ..fingerprint import attribute as attr
from ..utils.device import resolve_device
from .mesh import Mesh, make_mesh, replicate
from .solver import generate_on_mesh, place_pipeline, solve_placed
from .train import make_mesh_chunk_runners


def process_index() -> int:
    """This process's rank (0 without a process group): rank 0 writes a run's files."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def broadcast_one_to_all(obj: Any) -> Any:
    """Rank 0's ``obj`` (any picklable value) on every rank."""
    if not dist.is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def rank_device(device, rank: int = 0) -> torch.device:
    """This rank's device: ``cuda:{LOCAL_RANK % device_count}`` for a CUDA
    run (``resolve_device``: it raises without a card), the CPU if asked."""
    device = torch.device(device)
    if device.type != "cuda":
        return resolve_device(device)
    resolve_device("cuda")
    local = int(os.environ.get("LOCAL_RANK", rank))
    device = resolve_device(f"cuda:{local % torch.cuda.device_count()}")
    torch.cuda.set_device(device)
    return device


def choose_backend(device: torch.device, world: int) -> str:
    """nccl when every rank of this host has a card of its own, else gloo."""
    if device.type != "cuda":
        return "gloo"
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    return "nccl" if local_world <= torch.cuda.device_count() else "gloo"


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device,
    timeout: Optional[float] = None,
) -> torch.device:
    """Join (or start) the process group; idempotent.  Returns this rank's device.

    Without arguments it reads torchrun's environment (``env://``:
    ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).  A
    ``coordinator_address`` "host:port" means ``tcp://host:port``; a URL
    (``tcp://``, ``file://``) is used as it is, with ``num_processes`` and
    ``process_id``.  ``timeout`` (seconds) bounds every collective's wait:
    a rank left waiting that long raises instead of hanging (torch's
    default, 30 minutes, when None)."""
    rank = process_id if process_id is not None else int(os.environ.get("RANK", "0"))
    if dist.is_initialized():
        return rank_device(device, dist.get_rank())
    world = num_processes if num_processes is not None else int(os.environ.get("WORLD_SIZE", "1"))
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = "tcp://" + coordinator_address
    device = rank_device(device, rank)
    backend = choose_backend(device, world)
    print(f"[parallel] rank {rank} of {world}: device {device}, backend {backend}", flush=True)
    kw = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank, **kw)
    return device


def global_mesh(model: int = 1) -> Mesh:
    """('data', 'model') grid over every rank of the process group."""
    n = process_count()
    if n % model:
        raise ValueError(f"{n} global devices not divisible by model={model}")
    return make_mesh(data=n // model, model=model)


def shard_local_batch(mesh: Mesh, local_x: Any, axis: int = 0) -> torch.Tensor:
    """This rank's part of a GLOBAL array whose ``axis`` shards over "data".

    Each rank passes its own [S_local, ...] rows and keeps them: the global
    array is the ranks' rows in order along "data" (the order ``parallel.mesh``
    gathers in), so there is nothing to move."""
    return torch.as_tensor(local_x)


def replicate_global(mesh: Mesh, tree: Any) -> Any:
    """Replicate a (rank-identical) tree across the process group."""
    return replicate(mesh, tree)


def process_allgather(x: torch.Tensor) -> np.ndarray:
    """Every rank's ``x`` concatenated on dim 0 in rank order, as numpy on every rank."""
    if not dist.is_initialized():
        return x.detach().cpu().numpy()
    y = x.detach().contiguous()
    if y.is_cuda and dist.get_backend() == "gloo":
        y = y.cpu()
    parts = [torch.empty_like(y) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, y)
    return torch.cat(parts).cpu().numpy()


def attribute_multihost(
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
    """Run the solver SPMD over the process group.

    Every rank passes its OWN ``local_targets`` rows; weights, basis and noise
    must be rank-identical (same checkpoint or seed) and are replicated.  The
    restart starts are drawn for the global sample count from ``generator``
    (``kwargs``), so each rank solves the starts the single-process solve gives
    its rows.  Returns the global result on every rank."""
    global_samples = local_targets.shape[0] * process_count()
    data = mesh.shape["data"]
    if global_samples % data != 0:
        raise ValueError(
            f"global sample count {global_samples} "
            f"({local_targets.shape[0]} x {process_count()} processes) "
            f"not divisible by data axis {data}"
        )
    return solve_placed(
        mesh, gen_params, lpips_params, basis, noise,
        shard_local_batch(mesh, local_targets),
        mcfg=mcfg, acfg=acfg, shard_model=shard_model, **kwargs,
    )


def train_multihost_chunk_runners(mesh: Mesh, mcfg: ModelConfig, tcfg):
    """GAN-training chunk runners over the process group: the mesh runners of
    ``parallel/train.py`` (the state replicated, each rank training on its rows
    of the global batch, gradients averaged over "data")."""
    nproc = process_count()
    if tcfg.batch % nproc:
        raise ValueError(f"global batch {tcfg.batch} not divisible by {nproc} processes")
    return make_mesh_chunk_runners(mesh, mcfg, tcfg)


def generate_multihost(
    mesh: Mesh,
    pipe,
    global_batch: int,
    generator: torch.Generator,
    *,
    shard_model: bool = False,
):
    """Fingerprinted generation over the process group.

    Every rank passes a pipeline built from the same checkpoint or seed and a
    generator of the same seed: the latent draw (``generate_fingerprinted``'s
    stream) is made for the whole batch on every rank, each rank synthesizes
    its rows, and the images are gathered.  Returns the
    ``generate_fingerprinted`` tuple for the global batch on every rank."""
    data = mesh.shape["data"]
    nproc = process_count()
    if global_batch % data != 0:
        raise ValueError(f"global batch {global_batch} not divisible by data axis {data}")
    if global_batch % nproc != 0:
        raise ValueError(f"global batch {global_batch} not divisible by {nproc} processes")
    return generate_on_mesh(mesh, place_pipeline(mesh, pipe, shard_model=shard_model), global_batch, generator)

