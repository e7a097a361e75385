"""The device trace of a traced window, reduced to what the per-layer readers
need.

``Tracer`` runs ``torch.profiler`` (CPU and CUDA activities, input shapes
recorded) around the window, which the harness marks with the annotation
``gpubench.window``. ``TraceData.from_events`` keeps, of the profiler's raw
events, the host ops (name, thread, start, end, shapes, dtypes) and the
device activities (kernels, copies, sets) with the host op each was
launched under. Everything is clipped to the window's annotation.

- ``busy_s``: the union of device activity inside the window;
- ``device_s_under(prefixes)``: device time of the kernels launched while a
  host op whose name starts with one of ``prefixes`` ran on the launching
  thread: attribution by op, so a rewritten kernel under the same op is
  still counted;
- ``calls(prefixes)``: those host ops themselves, with their shapes;
- ``breakdown()``: the device operations that took most time, and the
  longest idle gaps by the host op that ran on the thread that launched the
  next device operation.
"""

from __future__ import annotations

import bisect
import collections
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple

__all__ = ["HostOp", "DeviceOp", "TraceData", "Tracer", "WINDOW"]

WINDOW = "gpubench.window"


class HostOp(NamedTuple):
    id: int
    name: str
    tid: int
    start: int  # ns, the profiler's clock
    end: int
    shapes: tuple
    dtypes: tuple


class DeviceOp(NamedTuple):
    name: str
    start: int
    end: int
    link: int  # the id of the host op it was launched under, 0 if none


def _union(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class TraceData:
    def __init__(self, host: Sequence[HostOp], device: Sequence[DeviceOp],
                 window: Tuple[int, int]):
        self.window = window
        w0, w1 = window
        self.host = [h for h in host if h.end > w0 and h.start < w1]
        self.device = [DeviceOp(d.name, max(d.start, w0), min(d.end, w1), d.link)
                       for d in device if d.end > w0 and d.start < w1]
        self._by_id = {h.id: h for h in self.host}

    @classmethod
    def from_events(cls, events) -> "TraceData":
        """From ``prof.profiler.kineto_results.events()``: host ops are the
        CPU events linked to no other (ops and annotations; runtime calls
        link to the op that made them), device work the CUDA events that are
        not annotations (a device-side annotation marks a range and runs
        nothing)."""
        host, device, window = [], [], None
        for e in events:
            start, end = e.start_ns(), e.end_ns()
            if e.device_type().name == "CPU":
                if e.linked_correlation_id() != 0:
                    continue
                op = HostOp(e.correlation_id(), e.name(), e.start_thread_id(), start, end,
                            tuple(tuple(s) for s in e.shapes()), tuple(e.dtypes()))
                if op.name == WINDOW:
                    window = (op.start, op.end)
                host.append(op)
            elif not e.is_user_annotation():
                device.append(DeviceOp(e.name(), start, end, e.linked_correlation_id()))
        if window is None:
            raise RuntimeError(f"the trace holds no {WINDOW!r} annotation")
        return cls(host, device, window)

    # -- whole-window quantities ------------------------------------------

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def busy_s(self) -> float:
        return sum(e - s for s, e in _union((d.start, d.end) for d in self.device)) * 1e-9

    # -- attribution by host op -------------------------------------------

    def calls(self, prefixes: Sequence[str]) -> List[HostOp]:
        """The host ops whose names start with one of ``prefixes``, outermost
        only (an op of that kind nested in another is part of it)."""
        found = sorted((h for h in self.host if h.name.startswith(tuple(prefixes))),
                       key=lambda h: (h.tid, h.start, -h.end))
        out: List[HostOp] = []
        for h in found:
            if out and out[-1].tid == h.tid and h.end <= out[-1].end:
                continue
            out.append(h)
        return out

    def device_s_under(self, prefixes: Sequence[str]) -> Tuple[float, int]:
        """(device seconds, kernels) launched under the ops of ``calls``."""
        spans: Dict[int, Tuple[List[int], List[int]]] = {}
        for h in self.calls(prefixes):
            starts, ends = spans.setdefault(h.tid, ([], []))
            starts.append(h.start)
            ends.append(h.end)
        total, count = 0, 0
        for d in self.device:
            launcher = self._by_id.get(d.link)
            if launcher is None or launcher.tid not in spans:
                continue
            starts, ends = spans[launcher.tid]
            i = bisect.bisect_right(starts, launcher.start) - 1
            if i >= 0 and launcher.end <= ends[i]:
                total += d.end - d.start
                count += 1
        return total * 1e-9, count

    # -- the breakdown ------------------------------------------------------

    def _outermost(self) -> Dict[int, Tuple[List[int], List[HostOp]]]:
        by_tid: Dict[int, List[HostOp]] = collections.defaultdict(list)
        for h in sorted(self.host, key=lambda h: (h.start, -h.end)):
            if h.name == WINDOW:
                continue
            ops = by_tid[h.tid]
            if ops and h.end <= ops[-1].end:
                continue
            ops.append(h)
        return {tid: ([h.start for h in ops], ops) for tid, ops in by_tid.items()}

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        per_name: Dict[str, int] = collections.Counter()
        for d in self.device:
            per_name[d.name] += d.end - d.start
        device_ops = [[name[:120], ns * 1e-9] for name, ns in
                      sorted(per_name.items(), key=lambda kv: -kv[1])[:top]]
        outer = self._outermost()
        ordered = sorted(self.device, key=lambda d: d.start)
        gaps: Dict[str, int] = collections.Counter()
        t = self.window[0]
        for d in ordered:
            if d.start > t:
                gaps[self._doing(outer, d, (t + d.start) // 2)] += d.start - t
            t = max(t, d.end)
        if self.window[1] > t:
            gaps["(window end: no further device work)"] += self.window[1] - t
        idle = [[label[:120], ns * 1e-9] for label, ns in
                sorted(gaps.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": device_ops, "idle_gaps": idle}

    def _doing(self, outer, nxt: DeviceOp, t: int) -> str:
        launcher = self._by_id.get(nxt.link)
        if launcher is None or launcher.tid not in outer:
            return "(no host op launched the next device work)"
        starts, ops = outer[launcher.tid]
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and ops[i].end >= t:
            return ops[i].name
        return f"(between host ops; next launched by {launcher.name})"


class Tracer:
    """``torch.profiler`` over one window; ``data`` after the window."""

    def __init__(self):
        import torch

        # every thread: the engine's dispatcher and the Loader's producer run
        # ops on threads the window's thread did not start
        every_thread = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
        self._prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA],
            record_shapes=True, experimental_config=every_thread)
        self.data: Optional[TraceData] = None

    def __enter__(self):
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.data = TraceData.from_events(self._prof.profiler.kineto_results.events())
        self._prof = None
        return False
