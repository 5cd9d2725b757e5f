"""A ("data", "model") grid of ranks and the placement helpers on it.

Counterpart of the reference package's ``parallel/mesh.py``.  PyTorch runs
one process per device, so JAX's single-process mesh over local devices
becomes a grid of the ranks of one ``torch.distributed`` process group
(joined by ``parallel.multihost.initialize``):

- axis **"data"**: the embarrassingly parallel axes --- attribution samples
  x restarts, the generation batch, the training batch.  A rank holds its
  rows; results come back by a gather over "data" in sample order.  A
  training batch whose minibatch-stddev groups do not split whole over the
  ranks is gathered inside the discriminator (:func:`gather_rows`, whose
  backward sums the cotangents over "data").
- axis **"model"**: tensor parallelism for synthesis.  The styled convs'
  weights and activation biases shard their output channels over "model"
  (:func:`shard_generator_params`); synthesis gathers the channels after
  each sharded conv.  The gradients follow the Megatron pattern, written out
  where the reference leaves them to GSPMD: the gather's backward is the
  rank's slice (everything after it is replicated), and the input of every
  sharded conv and the style that modulates it pass through an identity
  whose backward sums over "model" (each rank holds only its channels'
  part of their gradients).

A process that joined no group is a world of one: rank 0, every collective
the identity.  Collectives of a gloo group stage CUDA tensors through the
host (gloo's collectives are host ones); nccl takes them where they are.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..utils.tree import tree_leaves

AXES = ("data", "model")


@dataclasses.dataclass(frozen=True)
class Mesh:
    ranks: np.ndarray  # [data, model] global ranks
    groups: Dict[str, Any]  # axis -> this rank's process group along it (None: a world of one)
    rank: int  # this process's global rank
    backend: Optional[str]  # the process group's backend (None: a world of one)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(AXES, self.ranks.shape))

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        where = np.argwhere(self.ranks == self.rank)
        if not len(where):
            raise ValueError(f"rank {self.rank} is not in the mesh {self.ranks.tolist()}")
        return int(where[0][AXES.index(axis)])


def make_mesh(data: int = 0, model: int = 1, ranks: Optional[Sequence[int]] = None) -> Mesh:
    """Build a ('data', 'model') grid over ``ranks`` (all ranks of the process
    group by default).  data=0 => use all remaining ranks."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    ranks = sorted(range(world) if ranks is None else ranks)
    n = len(ranks)
    if data <= 0:
        if n % model != 0:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    need = data * model
    if need > n:
        raise ValueError(f"mesh {data}x{model} needs {need} devices, have {n}")
    grid = np.asarray(ranks[:need]).reshape(data, model)
    if not dist.is_initialized():
        return Mesh(grid, {axis: None for axis in AXES}, 0, None)
    rank = dist.get_rank()
    groups = {}
    # every rank creates every group, in one order (torch.distributed's rule)
    for axis, lines in (("data", grid.T), ("model", grid)):
        for line in lines:
            group = dist.new_group([int(r) for r in line])
            if rank in line:
                groups[axis] = group
    return Mesh(grid, {axis: groups.get(axis) for axis in AXES}, rank, dist.get_backend())


def _staged(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    return x.cpu() if x.is_cuda and mesh.backend == "gloo" else x


def all_gather_rows(mesh: Mesh, x: torch.Tensor, axis: str = "data") -> torch.Tensor:
    """Every rank's ``x`` along ``axis``, concatenated on dim 0 in the axis's
    order (a list-form all_gather; the shapes are equal)."""
    group = mesh.groups[axis]
    if group is None:
        return x
    y = _staged(mesh, x.contiguous())
    parts = [torch.empty_like(y) for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, y, group=group)
    return torch.cat(parts).to(x.device)


def all_reduce_mean_(mesh: Mesh, tensors: Sequence[torch.Tensor], axis: str = "data") -> None:
    """Replace each tensor (float32, one device) by its mean over ``axis``:
    one all_reduce of their concatenation."""
    group = mesh.groups[axis]
    if group is None or not tensors:
        return
    flat = _staged(mesh, torch.cat([t.reshape(-1) for t in tensors]))
    dist.all_reduce(flat, group=group)
    flat = flat.to(tensors[0].device) / mesh.shape[axis]
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def replicated(mesh: Mesh) -> Callable[[torch.Tensor], torch.Tensor]:
    """The placement of a replicated tensor: every rank of the process group
    takes the values of the mesh's first rank (a broadcast, in place)."""
    src = int(mesh.ranks[0, 0])

    def place(x: torch.Tensor) -> torch.Tensor:
        if mesh.backend is None or not torch.is_tensor(x):
            return x
        y = _staged(mesh, x.contiguous())
        dist.broadcast(y, src=src)
        if y is not x:
            x.copy_(y)
        return x

    return place


def data_sharded(mesh: Mesh, axis: int = 0) -> Callable[[torch.Tensor], torch.Tensor]:
    """The placement of a tensor whose ``axis`` shards over "data": this
    rank's contiguous block of rows (a view)."""
    d = mesh.shape["data"]

    def place(x: torch.Tensor) -> torch.Tensor:
        n = x.shape[axis]
        if n % d:
            raise ValueError(f"axis {axis} of size {n} not divisible by data axis {d}")
        return x.narrow(axis, mesh.index("data") * (n // d), n // d)

    return place


def shard_batch(mesh: Mesh, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """This rank's rows of a global tensor whose ``axis`` shards over "data"."""
    return data_sharded(mesh, axis)(x)


def replicate(mesh: Mesh, tree: Any) -> Any:
    """Replicate a tree of tensors across the process group: every leaf is
    broadcast from the mesh's first rank, in place, and the tree returned.
    Weights drawn from one seed are equal already; the broadcast makes them
    so whatever drew them."""
    place = replicated(mesh)
    for leaf in tree_leaves(tree):
        place(leaf)
    return tree


class _SumGradOverModel(torch.autograd.Function):
    """The identity; its backward sums the gradient over "model"."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        y = _staged(mesh, g.contiguous()).clone()
        dist.all_reduce(y, group=mesh.groups["model"])
        return y.to(g.device), None


class _GatherChannels(torch.autograd.Function):
    """Every "model" rank's channels (the last axis), concatenated in rank
    order; its backward is the rank's slice of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.c = mesh, x.shape[-1]
        y = _staged(mesh, x.contiguous())
        parts = [torch.empty_like(y) for _ in range(mesh.shape["model"])]
        dist.all_gather(parts, y, group=mesh.groups["model"])
        return torch.cat(parts, dim=-1).to(x.device)

    @staticmethod
    def backward(ctx, g):
        i = ctx.mesh.index("model")
        return g[..., i * ctx.c:(i + 1) * ctx.c].contiguous(), None


class _GatherRows(torch.autograd.Function):
    """Every "data" rank's rows (dim 0), concatenated in rank order: the
    global batch of a tensor in the contiguous layout (:func:`data_sharded`).
    Its backward is :class:`_SumRowsOverData`, so that a gradient taken with
    ``create_graph=True`` (the R1 penalty) can be differentiated again."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return all_gather_rows(mesh, x)

    @staticmethod
    def backward(ctx, g):
        return _SumRowsOverData.apply(g, ctx.mesh), None


class _SumRowsOverData(torch.autograd.Function):
    """This rank's rows of the sum over "data" of every rank's global-batch
    tensor: a reduce-scatter, written as an all_reduce and the rank's slice
    (gloo has no reduce-scatter).  Its backward is :class:`_GatherRows`."""

    @staticmethod
    def forward(ctx, g, mesh):
        ctx.mesh = mesh
        y = _staged(mesh, g.contiguous()).clone()
        dist.all_reduce(y, group=mesh.groups["data"])
        n = g.shape[0] // mesh.shape["data"]
        return y[mesh.index("data") * n:(mesh.index("data") + 1) * n].to(g.device)

    @staticmethod
    def backward(ctx, g):
        return _GatherRows.apply(g, ctx.mesh), None


def gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The global batch of ``x``, this rank's contiguous rows, on every rank.

    The backward sums the cotangents over "data"; it does not average them.
    Each rank's loss L_r is the mean over its own rows and the parameter
    gradients are averaged over "data" afterwards (``training.gan._grads``), so
    (1/R) * sum_r d(sum_r' L_r')/d(theta) through rank r's rows = dL_global/d(theta):
    a rank's rows receive the gradient of every rank's loss, as the reference's
    global-batch ``grad`` gives them."""
    return _GatherRows.apply(x, mesh)


def sum_grad_over_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _SumGradOverModel.apply(x, mesh)


def gather_channels(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _GatherChannels.apply(x, mesh)


def shard_generator_params(mesh: Mesh, params: Any) -> Any:
    """Tensor-parallel placement of the synthesis network (a new tree).

    Styled-conv weights [kh, kw, I, O] and their activation biases [O] keep
    this rank's block of the output channels when "model" divides O; such a
    conv's dict carries the mesh under ``"model_shard"``, which tells
    ``models.stylegan2.styled_conv`` to gather.  Modulation, mapping, the
    constant input and ToRGB (O = 3) stay replicated.  Every tensor is first
    replicated from the mesh's first rank.

    A tree without ``"convs"`` (BigGAN) is returned replicated: the
    reference's placement shards only 4-D leaves named ``weight`` and
    ``act_bias`` leaves, and BigGAN's convs are ``w`` and its only ``weight``
    leaves are 1-D batch-norm scales, so every rank runs the whole network."""
    replicate(mesh, params)
    m = mesh.shape["model"]
    if m == 1 or "convs" not in params:
        return params
    i = mesh.index("model")

    def shard(p):
        o = p["weight"].shape[-1]
        if o % m or o <= 3:
            return p
        k = o // m
        return {**p, "weight": p["weight"][..., i * k:(i + 1) * k].contiguous(),
                "act_bias": p["act_bias"][i * k:(i + 1) * k].contiguous(), "model_shard": mesh}

    return {**params, "conv1": shard(params["conv1"]), "convs": [shard(p) for p in params["convs"]]}
