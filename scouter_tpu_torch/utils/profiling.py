"""Tracing and profiling (counterpart of ``scouter_tpu/utils/profiling.py``).

- :func:`trace`: a ``torch.profiler`` session around a region, over every
  thread, written as a Chrome/TensorBoard trace file into ``log_dir``: the
  kernels, the program's spans (``utils/tracing.py``) and the stages of each
  request the engine answered in the region;
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
import json
import os
import socket
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from ..core.device import resolve_device
from . import tracing

__all__ = ["REQUESTS_PID", "Timer", "model_cost_analysis", "request_events", "trace"]

REQUESTS_PID = 1 << 30  # the trace's process of request events: no real pid or device
_STAGES = ("formed", "launched", "picked", "answered")


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the region (CPU on every thread, and the card where there is
    one) and write ``<host>.<pid>.<ns>.pt.trace.json`` into ``log_dir``: the
    profiler's events, the program's ``engine.*`` and ``loader.*`` spans
    among them, and each request the engine answered in the region (see
    :func:`request_events`). Yields the ``torch.profiler.profile`` object."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    # every thread: the engine's dispatcher and resolvers and the Loader's
    # producer are threads the region's own thread did not start
    every_thread = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    start = tracing.now_ns()
    with torch.profiler.profile(activities=activities, experimental_config=every_thread) as prof:
        yield prof
    end = tracing.now_ns()
    path = os.path.join(log_dir, f"{socket.gethostname()}.{os.getpid()}.{end}.pt.trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        chrome = json.load(f)
    chrome["traceEvents"] += request_events(tracing.records(start, end),
                                            chrome.get("baseTimeNanoseconds", 0))
    with open(path, "w") as f:
        json.dump(chrome, f)


def request_events(r, base_ns: int = 0) -> list:
    """Chrome trace complete events of request records (``tracing.records``)
    on the profiler's clock (``ts`` in us after ``base_ns``), in a process
    named "requests": one track a batch in flight, reused once the batch is
    answered, holding a ``queue`` event a request (submitted -> batch
    formed) and the batch's ``dispatch``, ``inflight`` and ``fetch``; the
    arguments carry the ids, ``live`` and ``bucket``."""
    events = [{"ph": "M", "name": "process_name", "pid": REQUESTS_PID,
               "args": {"name": "requests"}}]
    rows = {}  # batch -> its rows, by submission; batches by their first
    for i in np.argsort(r["submitted"], kind="stable"):
        rows.setdefault(int(r["batch"][i]), []).append(i)
    answered_at: list = []  # a track's last batch's answer
    for batch, mine in rows.items():
        j = mine[0]
        formed, launched, picked, answered = (int(r[k][j]) for k in _STAGES)
        tid = next((t for t, end in enumerate(answered_at) if end <= r["submitted"][j]),
                   len(answered_at))
        answered_at[tid:tid + 1] = [answered]
        args = {"batch": batch, "engine": int(r["engine"][j]), "live": int(r["live"][j]),
                "bucket": int(r["bucket"][j])}
        spans = [("queue", int(r["submitted"][i]), formed, dict(args, request=int(r["request"][i])))
                 for i in mine]
        spans += [("dispatch", formed, launched, args), ("inflight", launched, picked, args),
                  ("fetch", picked, answered, args)]
        events += [{"ph": "X", "name": name, "cat": "request", "pid": REQUESTS_PID, "tid": tid,
                    "ts": (t0 - base_ns) / 1e3, "dur": (t1 - t0) / 1e3, "args": a}
                   for name, t0, t1, a in spans]
    return events


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
