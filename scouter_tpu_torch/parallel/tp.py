"""Tensor-parallel and ZeRO-1 partition rules over a (data, model) mesh
(counterpart of ``scouter_tpu/parallel/tp.py``).

The rules are the JAX package's, computed in JAX's layout and mapped onto
torch's through the weight carrier's layout rules
(``models/convert.py::variables_to_state_dict``): an HWIO kernel's
out-channels (axis 3) are torch's dim 0, a flax Dense kernel is torch's
weight transposed, a Conv1d kernel (k, in, out) is torch's (out, in, k), an
EvoNorm's (C,) leaves are timm's (1, C, 1, 1), and the xSlot head's leaves
keep torch's layout. So each rank holds exactly the elements of each
parameter, BatchNorm statistic and AdamW moment that JAX's device at the same
mesh coordinate holds:

- ``model`` (tensor parallelism): a conv kernel's out-channels, the slot
  bank's slot axis, and the backbone's 1-D leaves (BN scale, bias and
  statistics, conv biases); every other leaf, ``num_batches_tracked`` too,
  is replicated;
- ``data`` (ZeRO-1): each AdamW moment also split along its largest free
  axis that divides, ties broken in JAX's axis order.

JAX leaves the compute to XLA. Here each rank stores its shards; a forward
gathers each sharded parameter over the ``model`` group (:func:`gather_shard`,
whose backward keeps this rank's slice of the full gradient: the ranks of one
model group compute the same full gradient on the same data), and buffers are
gathered the same way and sliced back after a train forward. So the model
axis saves memory, not time. ZeRO-1's step is ``train/state.py``'s.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .mesh import Mesh

__all__ = [
    "P",
    "StateShardings",
    "tp_enabled",
    "param_partition_spec",
    "train_state_shardings",
    "shard_train_state",
    "gather_shard",
    "gather_full",
    "local_slices",
    "torch_spec",
]


class P(tuple):
    """A partition spec: for each axis, the mesh axis it is split over or None."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"P{tuple(self)!r}"


Spec = Tuple[Optional[str], ...]


def tp_enabled(mesh: Optional[Mesh]) -> bool:
    """True when the mesh carries a ``model`` axis of more than one rank."""
    return mesh is not None and "model" in mesh.axis_names and int(mesh.shape["model"]) > 1


def _divisible(dim: int, n: int) -> bool:
    return n > 1 and dim % n == 0


def _in_backbone(path) -> bool:
    """True when a leaf's path (a torch name, or a sequence of keys) passes
    through ``backbone``."""
    keys = path.split(".") if isinstance(path, str) else [
        getattr(k, "key", getattr(k, "name", k)) for k in path]
    return "backbone" in keys


def param_partition_spec(shape, tp: int, path=None) -> P:
    """The TP spec of one leaf in JAX's layout (``scouter_tpu/parallel/tp.py:
    69-95``): a 4-D kernel's out-channels, a 3-D slot bank's slot axis, a
    1-D backbone leaf's channels; else replicated. ``path=None`` takes the
    leaf for a backbone one."""
    if len(shape) == 4 and _divisible(shape[3], tp):
        return P(None, None, None, "model")
    if len(shape) == 3 and _divisible(shape[1], tp):
        return P(None, "model", None)
    if len(shape) == 1 and _divisible(shape[0], tp) and (path is None or _in_backbone(path)):
        return P("model")
    return P()


def _zero1_spec(shape, base: P, dp: int) -> P:
    """``base`` with the largest free axis that divides split over ``data``
    (a stable sort: ties go to the first axis)."""
    spec = list(base) + [None] * (len(shape) - len(base))
    free = [i for i, s in enumerate(spec) if s is None]
    free.sort(key=lambda i: shape[i], reverse=True)
    for i in free:
        if _divisible(shape[i], dp):
            spec[i] = "data"
            return P(*spec)
    return base


def jax_layout(name: str, shape: Sequence[int], evo: bool = False
               ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """(the leaf's shape in JAX's layout, the torch dim of each JAX axis),
    by the weight carrier's rules."""
    shape = tuple(shape)
    if "slot" in name.split(".")[:-1]:
        axes: Tuple[int, ...] = tuple(range(len(shape)))
    elif evo:
        axes = (1,)
    elif len(shape) == 4:
        axes = (2, 3, 1, 0)  # HWIO <- OIHW
    elif len(shape) == 3:
        axes = (2, 1, 0)  # Conv1d (k, in, out) <- (out, in, k)
    elif len(shape) == 2:
        axes = (1, 0)  # Dense (in, out) <- (out, in)
    else:
        axes = tuple(range(len(shape)))
    return tuple(shape[a] for a in axes), axes


def torch_spec(name: str, shape: Sequence[int], tp: int, dp: int = 1, zero1: bool = False,
               evo: bool = False) -> Spec:
    """The spec of a torch leaf, dim by dim: JAX's spec of the same leaf in
    JAX's layout, mapped through :func:`jax_layout`. With ``zero1``, the
    spec of its AdamW moments."""
    jshape, axes = jax_layout(name, shape, evo)
    spec = param_partition_spec(jshape, tp, name)
    if zero1 and len(jshape) >= 1:
        spec = _zero1_spec(jshape, spec, dp)
    out: List[Optional[str]] = [None] * len(shape)
    for j, axis in enumerate(spec):
        if axis is not None:
            out[axes[j]] = axis
    return tuple(out)


def local_slices(shape: Sequence[int], spec: Spec, mesh: Mesh,
                 coords: Optional[Dict[str, int]] = None) -> Tuple[slice, ...]:
    """The block of a leaf of ``shape`` under ``spec`` that this rank holds,
    or the rank at ``coords`` (an index along each mesh axis)."""
    coords = mesh.coords() if coords is None else coords
    out = []
    for dim, axis in zip(shape, spec):
        if axis is None:
            out.append(slice(None))
        else:
            size = dim // mesh.size(axis)
            out.append(slice(coords[axis] * size, (coords[axis] + 1) * size))
    return tuple(out)


@dataclasses.dataclass
class StateShardings:
    """The layout of a train state: a torch-layout spec for each parameter,
    buffer and (trainable parameter's) AdamW moment; under ZeRO-1, the
    optimizer's leaves as ``(parameter, leaf, data dim or None)``."""

    mesh: Mesh
    params: Dict[str, Spec]
    buffers: Dict[str, Spec]
    moments: Dict[str, Spec]
    leaves: List[Tuple[torch.nn.Parameter, torch.Tensor, Optional[int]]] = dataclasses.field(
        default_factory=list)

    def gathered_names(self) -> List[str]:
        """Parameters and buffers split over ``model``, gathered for compute."""
        return [n for specs in (self.params, self.buffers) for n, s in specs.items()
                if "model" in s]


def _evo_names(model) -> set:
    return {n for n, m in model.named_modules() if type(m).__name__.startswith("EvoNorm")}


def train_state_shardings(state, mesh: Mesh, zero1: bool = False) -> StateShardings:
    """The layout of an unsharded ``train.state.TrainState`` on ``mesh``."""
    tp, dp = mesh.size("model"), mesh.size("data")
    evo = _evo_names(state.model)

    def spec(name, shape, moment=False):
        owner = name.rpartition(".")[0]
        return torch_spec(name, shape, tp, dp, zero1 and moment, owner in evo)

    named = list(state.model.named_parameters())
    return StateShardings(
        mesh=mesh,
        params={n: spec(n, p.shape) for n, p in named},
        buffers={n: spec(n, b.shape) for n, b in state.model.named_buffers()},
        moments={n: spec(n, p.shape, moment=True) for n, p in named if p.requires_grad})


def shard_train_state(state, mesh: Mesh, zero1: bool = False):
    """Keep only this rank's shards of the state's parameters and buffers;
    under ZeRO-1 the optimizer becomes AdamW over this rank's ``data``
    slices. Returns ``(state, shardings)``; ``state.shardings`` is set."""
    from ..train.state import make_optimizer

    sh = train_state_shardings(state, mesh, zero1)
    model = state.model
    with torch.no_grad():
        for specs, named in ((sh.params, model.named_parameters()),
                             (sh.buffers, model.named_buffers())):
            for name, t in named:
                if "model" in specs[name]:
                    t.data = t.data[local_slices(t.shape, specs[name], mesh)].clone()
        if zero1 and any("data" in s for s in sh.moments.values()):
            for name, p in model.named_parameters():
                if name not in sh.moments:
                    continue
                spec = tuple(None if a == "model" else a for a in sh.moments[name])
                z = spec.index("data") if "data" in spec else None
                leaf = p if z is None else p.detach()[local_slices(p.shape, spec, mesh)].clone()
                sh.leaves.append((p, leaf, z))
            lr = state.optimizer.param_groups[0]["lr"]
            state.optimizer = make_optimizer([leaf for _, leaf, _ in sh.leaves], lr)
    state.shardings = sh
    return state, sh


class _GatherShard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.index, ctx.size = dim, dist.get_rank(group), x.shape[dim]
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.index * ctx.size, ctx.size).contiguous(), None, None


def gather_shard(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The full tensor of the shards ``x`` of ``group``'s ranks along
    ``dim``. Its gradient is this rank's slice of the full gradient, not the
    sum over the group: the group's ranks each hold the same full gradient."""
    return _GatherShard.apply(x, dim, group)


def gather_full(t: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """The full value of a leaf this rank holds a block of (a collective
    over each axis the leaf is split on)."""
    with torch.no_grad():
        for dim, axis in enumerate(spec):
            if axis is not None:
                t = _GatherShard.apply(t, dim, mesh.group(axis))
    return t
