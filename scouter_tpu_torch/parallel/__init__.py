"""Meshes and partition rules over ``torch.distributed`` (counterpart of
``scouter_tpu/parallel``; the reference's NCCL DDP, ``tools/prepare_things.py:9-31``).

- a :class:`~.mesh.Mesh` lays the world's ranks out on a ``data`` axis and
  optionally a trailing ``model`` axis, one process per device;
- the batch is split over ``data`` (each rank loads its own rows), gradients
  are averaged over the ``data`` group, and BatchNorm takes its batch
  statistics over it unless ``--sync_bn false``;
- ``parallel/tp.py`` shards parameters over ``model`` and, with ZeRO-1,
  AdamW's moments over ``data``, by the JAX package's rules;
- ``is_main_process``/``save_on_master`` write from rank 0 only.
"""

from .mesh import (
    batch_sharding,
    host_shard_bounds,
    is_main_process,
    make_mesh,
    replicated_sharding,
    shard_batch,
)
from .tp import (
    param_partition_spec,
    shard_train_state,
    tp_enabled,
    train_state_shardings,
)

__all__ = [
    "batch_sharding",
    "host_shard_bounds",
    "is_main_process",
    "make_mesh",
    "param_partition_spec",
    "replicated_sharding",
    "shard_batch",
    "shard_train_state",
    "tp_enabled",
    "train_state_shardings",
]
