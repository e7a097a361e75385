"""Device mesh and batch sharding (counterpart of ``scouter_tpu/parallel/mesh.py``).

A :class:`Mesh` is a grid of the world's ranks with named axes, laid out as
JAX lays out its devices: data-major, so with shape (D, M) rank r sits at
(r // M, r % M). Each rank holds one process group per axis, the ranks that
differ from it along that axis only; an axis of size 1 has none, and at world
size 1 no collective runs at all. A mesh may instead hold ``torch.device``
entries of this one process (``devices=``), as a serving engine splits a
batch over them; such a mesh has no groups.

:func:`all_reduce_sum` is the one collective with a gradient that the steps
and BatchNorm need: its backward sums the incoming gradients over the group,
which is the gradient of a sum whose terms live on different ranks.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..core.distributed import get_rank, get_world_size
from ..core.distributed import is_main_process  # noqa: F401  (JAX's mesh module has it)

__all__ = [
    "Mesh",
    "NamedSharding",
    "all_reduce_sum",
    "make_mesh",
    "batch_sharding",
    "replicated_sharding",
    "shard_batch",
    "is_main_process",
    "host_shard_bounds",
]


class Mesh:
    """``devices`` (an object array of ranks or ``torch.device`` entries) with
    ``axis_names``; ``shape`` maps each name to its size, as JAX's does."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, devices.shape))
        self._groups: Dict[str, Optional[dist.ProcessGroup]] = {}
        self._coords: Optional[Dict[str, int]] = None
        if self.of_ranks() and get_world_size() > 1:
            self._make_groups()

    def of_ranks(self) -> bool:
        return all(isinstance(d, (int, np.integer)) for d in self.devices.flat)

    def _make_groups(self) -> None:
        """Every rank creates every group of every axis, in one order (as
        ``new_group`` requires), and keeps those it belongs to."""
        me = get_rank()
        where = np.argwhere(self.devices == me)
        if len(where) != 1:
            raise ValueError(f"rank {me} is not once in the mesh {self.devices.tolist()}")
        self._coords = dict(zip(self.axis_names, (int(i) for i in where[0])))
        for ax, name in enumerate(self.axis_names):
            if self.shape[name] == 1:
                self._groups[name] = None
                continue
            lines = np.moveaxis(self.devices, ax, -1).reshape(-1, self.shape[name])
            for line in lines:
                ranks = [int(r) for r in line]
                # a group numbers its ranks in ascending order: keep that the
                # order of the coordinate, which gathers rely on
                if ranks != sorted(ranks):
                    raise ValueError(f"mesh axis {name!r} lists ranks {ranks} out of order")
                group = dist.new_group(ranks)
                if me in ranks:
                    self._groups[name] = group

    def coords(self) -> Dict[str, int]:
        """This rank's index along each axis (all 0 in a world of one)."""
        if self._coords is None:
            return {name: 0 for name in self.axis_names}
        return dict(self._coords)

    def group(self, axis: str) -> Optional[dist.ProcessGroup]:
        """This rank's group along ``axis``; None where no collective runs."""
        return self._groups.get(axis)

    def size(self, axis: str) -> int:
        return int(self.shape.get(axis, 1))

    def rank_at(self, **coords: int) -> int:
        """The global rank at this rank's coordinates with ``coords`` put in."""
        mine = {**self.coords(), **coords}
        return int(self.devices[tuple(mine[n] for n in self.axis_names)])


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a partition spec: the axis of the mesh each dim is split
    over, or None."""

    mesh: Mesh
    spec: Tuple[Optional[str], ...]


def make_mesh(shape: Optional[Sequence[int]] = None, axis_names: Sequence[str] = ("data",),
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a mesh. Default: one ``data`` axis over every rank of the world.

    ``--mesh_shape 4,2`` with the default one-axis name list names the
    trailing axis ``model`` (the tensor-parallel axis of ``parallel/tp.py``);
    only one axis may be named so, as in the JAX package."""
    devices = list(devices if devices is not None else range(get_world_size()))
    if shape is None:
        shape = (len(devices),)
    if int(np.prod(shape)) != len(devices):
        raise ValueError(f"mesh shape {tuple(shape)} != {len(devices)} devices")
    grid = np.empty(len(devices), dtype=object)
    grid[:] = devices
    grid = grid.reshape(tuple(shape))
    names = tuple(axis_names)[: grid.ndim]
    if len(names) < grid.ndim:
        if grid.ndim - len(names) > 1 or "model" in names:
            raise ValueError(
                f"mesh shape {tuple(shape)} needs {grid.ndim} axis names "
                f"but only {names!r} given; the documented contract is "
                "'data[,model]' — pass explicit axis_names for 3-D+ meshes")
        names = names + ("model",)
    return Mesh(grid, names)


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """The batch's leading axis split over ``data``."""
    return NamedSharding(mesh, ("data",))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def shard_batch(mesh: Mesh, batch):
    """This rank's rows of a global batch (a dict of tensors or arrays, or
    one): the ``data`` coordinate's contiguous block of the leading axis."""
    d, n = mesh.coords().get("data", 0), mesh.size("data")

    def rows(x):
        b = x.shape[0]
        if b % n:
            raise ValueError(f"batch of {b} does not split over {n} data ranks")
        return x[d * (b // n):(d + 1) * (b // n)]

    if isinstance(batch, dict):
        return {k: rows(v) for k, v in batch.items()}
    return rows(batch)


def host_shard_bounds(num_examples: int, *, process_index: Optional[int] = None,
                      process_count: Optional[int] = None) -> Tuple[int, int]:
    """This process's contiguous shard [start, stop) of a dataset (the
    DistributedSampler's place): near-equal shards, the remainder spread
    over the first processes."""
    pi = get_rank() if process_index is None else process_index
    pc = get_world_size() if process_count is None else process_count
    base, rem = divmod(num_examples, pc)
    start = pi * base + min(pi, rem)
    stop = start + base + (1 if pi < rem else 0)
    return start, stop


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """The sum of ``x`` over ``group``, differentiable; ``x`` itself where
    ``group`` is None."""
    return x if group is None else _AllReduceSum.apply(x, group)
