"""Tracing and profiling (counterpart of ``scouter_tpu/utils/profiling.py``).

- :func:`trace`: a ``torch.profiler`` session around a region, written as a
  Chrome/TensorBoard trace file into ``log_dir``;
- :class:`Timer`: host-clock timing of a region, the card drained with
  ``torch.cuda.synchronize()`` before and after it (nothing extra on the
  CPU);
- :func:`model_cost_analysis`: FLOPs from
  ``torch.utils.flop_counter.FlopCounterMode`` and the bytes of the counted
  operations' operands and results. XLA's cost analysis counts the bytes of
  fused programs instead, so only the FLOPs compare across the packages.
"""

from __future__ import annotations

import contextlib
import os
import socket
import time
from typing import Any, Callable, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from ..core.device import resolve_device

__all__ = ["Timer", "model_cost_analysis", "trace"]


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the region (CPU, and the card where there is one) and write
    ``<host>.<pid>.<ns>.pt.trace.json`` into ``log_dir``. Yields the
    ``torch.profiler.profile`` object."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    name = f"{socket.gethostname()}.{os.getpid()}.{time.time_ns()}.pt.trace.json"
    prof.export_chrome_trace(os.path.join(log_dir, name))


class Timer:
    """Host-clock times of regions on ``device``; on the card each region
    starts and ends with ``torch.cuda.synchronize()``, so work queued before
    it is not charged to it and its own work is."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self.times = []

    def _drain(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def measure(self, result_getter: Optional[Callable[[], Any]] = None):
        self._drain()
        t0 = time.perf_counter()
        yield
        if result_getter is not None:
            result_getter()
        self._drain()
        self.times.append(time.perf_counter() - t0)

    @property
    def mean(self) -> float:
        return sum(self.times) / max(len(self.times), 1)


def _nbytes(tree) -> int:
    leaves, _ = tree_flatten(tree)
    return sum(t.numel() * t.element_size() for t in leaves if isinstance(t, torch.Tensor))


class _CountedBytes(TorchDispatchMode):
    """The operand and result bytes of every operation FlopCounterMode counts."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket in flop_registry:
            self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        return out


def model_cost_analysis(fn: Callable, *args) -> Dict[str, float]:
    """``{'flops': ..., 'bytes accessed': ...}`` of one call of ``fn(*args)``
    (run once, on the arguments' device)."""
    counter = FlopCounterMode(display=False)
    counted = _CountedBytes()
    with counter, counted:
        fn(*args)
    return {"flops": float(counter.get_total_flops()), "bytes accessed": float(counted.bytes)}
