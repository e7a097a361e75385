"""Process-group start-up and rank helpers (counterpart of
``scouter_tpu/core/distributed.py``; the reference's
``tools/prepare_things.py:9-46``).

One process runs per device. :func:`init_distributed_mode` reads the
environment that ``python -m torch.distributed.run`` sets (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) and starts
the default process group: NCCL for a CUDA device, gloo for the CPU, or the
``backend`` the caller names. With none of those variables set it does
nothing, and the rank helpers answer for a world of one process. Nothing
falls back: NCCL without a card, or a group that does not start, raises.
"""

from __future__ import annotations

import builtins
import datetime
import functools
import os
from typing import Optional, Union

import torch
import torch.distributed as dist

from .device import resolve_device

__all__ = [
    "init_distributed_mode",
    "is_dist_avail_and_initialized",
    "get_world_size",
    "get_rank",
    "is_main_process",
    "setup_for_distributed",
    "collective_device",
]

LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def init_distributed_mode(backend: Optional[str] = None, device=None,
                          timeout: Union[float, datetime.timedelta] = 1800.0) -> None:
    """Start the default process group from the launcher's environment.

    ``device``: this process's device, ``cuda:{LOCAL_RANK}`` unless named; a
    CUDA device is made current (``torch.cuda.set_device``) before the group
    starts. ``backend``: ``nccl`` for a CUDA device and ``gloo`` for the CPU
    unless named (gloo also takes CUDA tensors for ``all_reduce`` and
    ``broadcast``, so ranks that share one card can run over it).
    ``timeout``: seconds (or a timedelta) to wait for the other ranks.
    Non-master ranks' prints are silenced (:func:`setup_for_distributed`)."""
    if is_dist_avail_and_initialized():
        return
    if not any(k in os.environ for k in ("RANK", "WORLD_SIZE")):
        return  # not launched as a distributed job (prepare_things.py:17-21)
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    dev = resolve_device(f"cuda:{local}" if device is None else device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"the nccl backend needs a CUDA device, got {dev}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not isinstance(timeout, datetime.timedelta):
        timeout = datetime.timedelta(seconds=float(timeout))
    dist.init_process_group(backend, rank=rank, world_size=world, timeout=timeout)
    setup_for_distributed(rank == 0)


def is_dist_avail_and_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_world_size() -> int:
    return dist.get_world_size() if is_dist_avail_and_initialized() else 1


def get_rank() -> int:
    return dist.get_rank() if is_dist_avail_and_initialized() else 0


def is_main_process() -> bool:
    return get_rank() == 0


def collective_device() -> torch.device:
    """Where the default group's collectives take their tensors: the current
    CUDA device under NCCL, else the CPU."""
    if is_dist_avail_and_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def setup_for_distributed(is_master: bool) -> None:
    """Rank-0-only print (prepare_things.py:34-46): a non-master print is
    dropped unless it passes ``force=True``."""
    builtin_print = builtins.print

    @functools.wraps(builtin_print)
    def print_fn(*args, **kwargs):
        force = kwargs.pop("force", False)
        if is_master or force:
            builtin_print(*args, **kwargs)

    builtins.print = print_fn
