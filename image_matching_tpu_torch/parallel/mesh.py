"""The device mesh and the data axis's collectives — the counterpart of
`image_matching_tpu/parallel/mesh.py`, on `torch.distributed`.

A mesh lays the processes out row-major over named axes, as
`np.asarray(devices).reshape(sizes)` does in the JAX package: `data`
(batch parallelism), `model` (tensor parallelism, `parallel/sharding.py`),
`context` (the keypoint axis: `parallel/ring_attention.py`,
`sharded_sinkhorn.py`, `context_parallel.py`) and `pipe` (GNN stages:
`parallel/pipeline.py`). Each axis, as one rank sees it, is an `Axis`: its
size, the rank's index along it and the process group of the ranks that
share the rank's other coordinates. The JAX package's sharded code is a
`shard_map` body over global arrays, into which XLA inserts the
collectives; here each rank holds its shard, and the bodies call the
collectives of `parallel/collectives.py` on an axis by hand.

The data axis has the API of the data-only mesh: `Mesh.size`, `.rank`,
`.group` and `.shard` are its. The JAX package shards the batch over it and
lets GSPMD turn every reduction over the batch into a global one, so its
sharded step computes the unsharded step. Here each rank runs its dim-0
slice of the global batch, and the reductions are made global by hand: the
training code calls `all_sum` on what it sums over the batch (loss
normalisers, batch-norm statistics, metric counts; a differentiable
`all_reduce`) and `sync_gradients` after the backward (a bucketed
`all_reduce` of the gradients, summed: each rank's loss is its share of the
global one). Both reduce over the data axis only, whatever other axes the
mesh has. No `DistributedDataParallel`, no `torch.compile`. These read the
mesh that `use_mesh` makes current; without one (one process) they return
their input, and the code runs the unsharded step.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from image_matching_tpu_torch.parallel.distributed import rank as _global_rank
from image_matching_tpu_torch.parallel.distributed import world_size

BUCKET_BYTES = 25 * 2 ** 20  # gradients all-reduced in buckets of about this size


@dataclasses.dataclass(frozen=True)
class Axis:
    """One axis of a mesh as this rank sees it: `size` ranks, this rank at
    `index` along it, `ranks` the global ranks of the axis's group in axis
    order, `group` their process group (None where the axis needs no
    communication: one rank of several, or no process group)."""

    name: str
    size: int
    index: int
    ranks: tuple
    group: Optional[object] = None

    def shard(self, n: int) -> slice:
        """This rank's contiguous slice of a dimension of `n` split over the axis."""
        if n % self.size:
            raise ValueError(f"a dimension of {n} does not split over the {self.size} ranks of axis {self.name!r}")
        k = n // self.size
        return slice(self.index * k, (self.index + 1) * k)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A mesh as this process sees it. `size`, `rank` and `group` are the
    data axis's: `size` ranks, this process's shard `rank` of it, or none
    (`rank` None) where a data-only mesh leaves it out; `group` the axis's
    process group, None for an axis of one process. `axes` holds every axis
    (`axis(name)`); a mesh without a data axis has a data axis of one."""

    size: int
    rank: Optional[int]
    device: torch.device
    group: Optional[object] = None
    axes: tuple = ()

    @property
    def active(self) -> bool:
        return self.rank is not None

    def shard(self, n: int) -> slice:
        """This rank's slice of a global dim 0 of `n`."""
        if n % self.size:
            raise ValueError(f"a dim 0 of {n} does not split over {self.size} ranks")
        k = n // self.size
        return slice(self.rank * k, (self.rank + 1) * k)

    def axis(self, name: str) -> Axis:
        for a in self.axes:
            if a.name == name:
                return a
        raise ValueError(f"the mesh has no axis {name!r} (axes {[a.name for a in self.axes]})")

    @property
    def shape(self) -> dict:
        return {a.name: a.size for a in self.axes}


def make_mesh(axes: Optional[Mapping[str, int]] = None, device="cuda") -> Mesh:
    """A mesh from {axis: size} over the process group's ranks, laid out
    row-major (the last axis varies fastest). The sizes multiply to the
    world size; a data-only mesh may take fewer ranks (those past it hold
    no shard). Default: {"data": world size}. Every rank must call this
    with the same axes: the axes' groups are made collectively."""
    axes = dict(axes) if axes is not None else {"data": world_size()}
    if set(axes) == {"data"}:
        return _data_mesh(axes["data"], torch.device(device))
    n = math.prod(axes.values())
    if n != world_size():
        raise ValueError(f"mesh axes {axes} need {n} processes, have {world_size()}")
    made = _axes(tuple(axes), tuple(axes.values()))
    data = next((a for a in made if a.name == "data"), Axis("data", 1, 0, (_global_rank(),)))
    return Mesh(data.size, data.index, torch.device(device), data.group, made)


def _axes(names, sizes) -> tuple:
    """This rank's `Axis` of each named axis of a row-major grid of every
    rank. `dist.new_group` is collective: every rank makes every group, in
    one order, including the groups it is not in."""
    world, me = math.prod(sizes), _global_rank()
    grid = np.arange(world).reshape(sizes)
    out = []
    for i, (name, size) in enumerate(zip(names, sizes)):
        mine = None
        for line in np.moveaxis(grid, i, -1).reshape(-1, size):
            ranks = tuple(int(r) for r in line)
            if not dist.is_initialized():
                group = None
            elif size == world:  # a world of one too: its collectives run, over one rank
                group = dist.group.WORLD
            elif size == 1:
                group = None
            else:
                group = dist.new_group(list(ranks))
            if me in ranks:
                mine = Axis(name, size, ranks.index(me), ranks, group)
        out.append(mine)
    return tuple(out)


def make_data_mesh(batch_size: int, device="cuda") -> Mesh:
    """Data-parallel mesh over the largest rank count dividing the batch;
    ranks past it hold no shard (they must still call this: the axis's
    group is made collectively)."""
    n = max(d for d in range(1, world_size() + 1) if batch_size % d == 0)
    return _data_mesh(n, torch.device(device))


def _data_mesh(n: int, device: torch.device) -> Mesh:
    if n > world_size():
        raise ValueError(f"a data axis of {n} needs {n} processes, have {world_size()}")
    r = _global_rank()
    if not dist.is_initialized():
        return Mesh(1, 0, device, axes=(Axis("data", 1, 0, (0,)),))
    group = dist.group.WORLD if n == world_size() else dist.new_group(list(range(n)))
    if r >= n:
        return Mesh(n, None, device)
    return Mesh(n, r, device, group, (Axis("data", n, r, tuple(range(n)), group),))


def shard_batch(mesh: Mesh, batch):
    """This rank's dim-0 slice of every leaf of a global batch (a dict,
    list or tuple of tensors, arrays and lists), tensors and arrays as
    tensors on the mesh's device."""
    if isinstance(batch, Mapping):
        return {k: shard_batch(mesh, v) for k, v in batch.items()}
    if isinstance(batch, tuple) and not hasattr(batch, "_fields"):
        return tuple(shard_batch(mesh, v) for v in batch)
    if isinstance(batch, (np.ndarray, torch.Tensor)):
        t = torch.as_tensor(batch)
        return t[mesh.shard(t.shape[0])].to(mesh.device)
    if hasattr(batch, "_fields"):  # a NamedTuple of per-image draws
        return type(batch)(*(shard_batch(mesh, v) for v in batch))
    if isinstance(batch, list):
        return batch[mesh.shard(len(batch))]
    raise TypeError(f"shard_batch: cannot split a {type(batch).__name__}")


@torch.no_grad()
def replicate(mesh: Mesh, module: torch.nn.Module) -> None:
    """Broadcast the module's parameters and buffers from the axis's first rank."""
    if mesh.group is None:
        return
    src = mesh.axis("data").ranks[0]
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src=src, group=mesh.group)


_current: contextvars.ContextVar[Optional[Mesh]] = contextvars.ContextVar("mesh", default=None)


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]):
    """Make `mesh` the one `all_sum`, `global_count` and `sync_gradients` read."""
    token = _current.set(mesh)
    try:
        yield mesh
    finally:
        _current.reset(token)


def current_mesh() -> Optional[Mesh]:
    mesh = _current.get()
    return mesh if mesh is not None and mesh.group is not None else None


class _AllSum(torch.autograd.Function):
    """all_reduce(SUM) whose backward is the all_reduce(SUM) of the output's
    gradient: every rank's loss reads the sum, so the sum's cotangent is
    the sum of theirs."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_sum(x):
    """The sum of `x` over the current mesh's ranks (differentiable); `x`
    itself without a mesh."""
    mesh = current_mesh()
    if mesh is None:
        return x
    return _AllSum.apply(x, mesh.group)


def all_sum_dict(values: dict) -> dict:
    """`all_sum` of every scalar of a dict, in one all_reduce; the dict
    itself without a mesh. Ints and bools become tensors of their sum."""
    if current_mesh() is None:
        return values
    dev = next(v.device for v in values.values() if torch.is_tensor(v))
    tensors = {k: torch.as_tensor(v, device=dev).detach() for k, v in values.items()}
    summed = all_sum(torch.stack([t.float() for t in tensors.values()]))
    return {k: s.to(t.dtype) for (k, t), s in zip(tensors.items(), summed.unbind(0))}


def global_count(n: int) -> int:
    """A per-rank count of batch elements as the global batch's count."""
    mesh = current_mesh()
    return n * (mesh.size if mesh is not None else 1)


@torch.no_grad()
def sync_gradients(params) -> None:
    """Sum every parameter's gradient over the current mesh's ranks, in
    buckets of about `BUCKET_BYTES` (one flat all_reduce each, by dtype);
    nothing without a mesh."""
    mesh = current_mesh()
    if mesh is None:
        return
    buckets, size = [], 0
    for g in (p.grad for p in params if p.grad is not None):
        if not buckets or g.dtype != buckets[-1][0].dtype or size >= BUCKET_BYTES:
            buckets.append([])
            size = 0
        buckets[-1].append(g)
        size += g.numel() * g.element_size()
    for bucket in buckets:
        flat = torch.cat([g.reshape(-1) for g in bucket])
        dist.all_reduce(flat, group=mesh.group)
        offset = 0
        for g in bucket:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def local_shard(draws):
    """This rank's slice of draws made for the global batch (a tensor or a
    NamedTuple of per-image tensors) on the current mesh; the draws
    themselves without one."""
    mesh = current_mesh()
    return draws if mesh is None else shard_batch(mesh, draws)


__all__ = ["Axis", "Mesh", "make_mesh", "make_data_mesh", "shard_batch", "replicate", "use_mesh", "current_mesh",
           "all_sum", "all_sum_dict", "global_count", "sync_gradients", "local_shard"]
