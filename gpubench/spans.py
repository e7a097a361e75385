"""The arithmetic of the readers of the program's own spans and request
record (``scouter_tpu_torch/utils/tracing.py``). Each function takes the
run's ``Reading`` and returns the metric's value, or None where the run
holds nothing of its kind: no trace, no such span in it, no request record
(a program without one: the module is missing, and the reader says None
rather than raise). None is never turned into 0.

The request record's stamps are on the profiler's clock, so they are
clipped to the traced window's ``gpubench.window`` annotation as the trace's
own events are.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from .layers import Reading
from .trace import _union

__all__ = ["idle_held_pct", "loader_wait_ms", "queue_wait_p95_ms", "requests",
           "service_p95_ms"]

_LOADER_WAIT = ("loader.wait",)
_OPTIMIZER = ("Optimizer.step#",)  # the steps, as optimizer_ms counts them


def requests(r: Reading) -> Optional[Dict[str, np.ndarray]]:
    """The request record's rows in flight during the traced window; None
    without a trace or a record."""
    t = r.outcome.trace
    if t is None:
        return None
    try:
        from scouter_tpu_torch.utils import tracing
    except ImportError:
        return None
    rows = tracing.records(*t.window)
    return rows if len(rows["request"]) else None


def _submitted_in_window(r: Reading) -> Optional[Dict[str, np.ndarray]]:
    rows = requests(r)
    if rows is None:
        return None
    w0, w1 = r.outcome.trace.window
    keep = (rows["submitted"] >= w0) & (rows["submitted"] < w1)
    return {k: v[keep] for k, v in rows.items()} if keep.any() else None


def queue_wait_p95_ms(r: Reading) -> Optional[float]:
    """95th percentile, over the requests submitted in the window, of
    submitted -> batch formed."""
    rows = _submitted_in_window(r)
    if rows is None:
        return None
    return float(np.percentile(rows["formed"] - rows["submitted"], 95)) * 1e-6


def service_p95_ms(r: Reading) -> Optional[float]:
    """95th percentile, over the same requests, of batch formed -> answer on
    the host."""
    rows = _submitted_in_window(r)
    if rows is None:
        return None
    return float(np.percentile(rows["answered"] - rows["formed"], 95)) * 1e-6


def _overlap(a: List[Tuple[int, int]], b: List[Tuple[int, int]]) -> int:
    """Length of the intersection of two sorted lists of disjoint intervals."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_held_pct(r: Reading) -> Optional[float]:
    """Share of the window in which the card ran nothing while the engine
    held a formed batch whose launches were not yet issued (the union of
    formed -> launched over the requests, clipped to the window: the
    dispatcher stacking, padding and launching it), intersected with the
    window's device-idle time. A request still waiting for its batch to
    form is not counted: that wait is the queue's."""
    t = r.outcome.trace
    rows = requests(r)
    if rows is None or not t.device:
        return None
    w0, w1 = t.window
    clipped = ((max(s, w0), min(e, w1)) for s, e in zip(rows["formed"].tolist(),
                                                         rows["launched"].tolist()))
    held = _union((s, e) for s, e in clipped if e > s)
    busy = _union((d.start, d.end) for d in t.device)
    idle, at = [], w0
    for s, e in busy:
        if s > at:
            idle.append((at, s))
        at = max(at, e)
    if w1 > at:
        idle.append((at, w1))
    return 100.0 * _overlap(held, idle) / (w1 - w0)


def loader_wait_ms(r: Reading) -> Optional[float]:
    """The consumer's ``loader.wait`` span time inside the window over the
    window's optimizer steps."""
    t = r.outcome.trace
    if t is None:
        return None
    waits = t.calls(_LOADER_WAIT)
    steps = len(t.calls(_OPTIMIZER))
    if not waits or not steps:
        return None
    w0, w1 = t.window
    ns = sum(max(0, min(h.end, w1) - max(h.start, w0)) for h in waits)
    return ns * 1e-6 / steps
