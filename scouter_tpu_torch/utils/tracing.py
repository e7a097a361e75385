"""The port's spans and its record of served requests.

- :func:`span`: a named range in the ``torch.profiler`` trace, on the
  profiler's own clock. It is on only while a profiler session runs (a
  benchmark's traced window, :func:`utils.profiling.trace`); otherwise it
  costs one flag check and returns a shared null context. Spans mark where
  a thread of the program does host work or waits outside any aten op, so
  that an idle gap on the card can be named by what the host was doing:

  - ``engine.await``: the dispatcher blocked on an empty request queue;
  - ``engine.form``: the dispatcher holding requests, waiting for more;
  - ``engine.slot``: the dispatcher waiting for an in-flight slot;
  - ``engine.stage``: stacking and padding a batch on the host;
  - ``engine.pick``: a resolver waiting for a dispatched batch;
  - ``engine.fetch``: a resolver's device->host copy of a batch's answers;
  - ``engine.resolve``: a resolver setting the futures (callers' callbacks);
  - ``loader.wait``: the Loader's consumer blocked on its producer;
  - ``loader.gather``: the Loader's producer gathering and pinning a batch.

  No span wraps code that launches kernels beyond one copy: the aten ops
  under it would lose their names in a trace read by outermost op.

- The request record: one row a request the engine answered, always on,
  in a ring of ``CAPACITY`` rows of int64 columns (``FIELDS``) allocated
  with the module: the request id (given by ``submit``), the batch id,
  the engine id, and five stamps in ns on the profiler's clock
  (``time.time_ns``, which kineto stamps its events with): submitted, batch
  formed, launches issued, picked by a resolver, answer on the host; then
  the batch's live rows and bucket. Past ``CAPACITY`` requests the newest
  are kept. :func:`records` reads it, for a window or an engine, after the
  engine is closed too.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler

__all__ = ["CAPACITY", "FIELDS", "new_id", "now_ns", "record_batch", "records", "span"]

CAPACITY = 1 << 17  # rows of the ring: 10 MiB, a 51 s window at 2500 requests a second
FIELDS = ("request", "batch", "engine", "submitted", "formed", "launched", "picked",
          "answered", "live", "bucket")
_REQUEST, _SUBMITTED = FIELDS.index("request"), FIELDS.index("submitted")

now_ns = time.time_ns  # the clock of the profiler's events

_NULL = contextlib.nullcontext()
_ids = itertools.count(1)  # request, batch and engine ids, unique in the process
_lock = threading.Lock()
_ring = np.zeros((CAPACITY, len(FIELDS)), np.int64)
_written = 0  # rows ever written; the newest is at (_written - 1) % len(_ring)


def span(name: str, **ids):
    """A ``record_function`` range named ``name`` while a profiler session
    runs (``ids`` go into its arguments); a shared null context otherwise.
    The profiler's Python flag is the check: ``_profiler_enabled()`` reads a
    thread's own state, which a session over every thread leaves unset."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NULL
    args = ", ".join(f"{k}={v}" for k, v in ids.items()) if ids else None
    return torch.profiler.record_function(name, args)


def new_id() -> int:
    return next(_ids)


def record_batch(engine: int, batch: int, requests: Sequence[int], submitted: Sequence[int],
                 formed: int, launched: int, picked: int, answered: int, bucket: int) -> None:
    """One row for each request of an answered batch, written a column at a
    time, over the oldest rows once the ring is full."""
    global _written
    n = len(requests)
    with _lock:
        ring, start, done = _ring, _written, 0
        _written += n
        while done < n:  # at most twice: a batch is far smaller than the ring
            i = (start + done) % len(ring)
            m = min(n - done, len(ring) - i)
            rows = ring[i:i + m]
            rows[:] = (0, batch, engine, 0, formed, launched, picked, answered, n, bucket)
            rows[:, _REQUEST] = requests[done:done + m]
            rows[:, _SUBMITTED] = submitted[done:done + m]
            done += m


def records(start_ns: Optional[int] = None, end_ns: Optional[int] = None,
            engine: Optional[int] = None) -> Dict[str, np.ndarray]:
    """The kept rows, oldest first, as a column a field: those of requests
    in flight at some time in ``[start_ns, end_ns)`` (submitted before its
    end, answered after its start) and, with ``engine``, of that engine."""
    with _lock:
        if _written <= len(_ring):
            rows = _ring[:_written].copy()
        else:
            i = _written % len(_ring)
            rows = np.concatenate([_ring[i:], _ring[:i]])
    cols = dict(zip(FIELDS, rows.T))
    keep = np.ones(len(rows), bool)
    if start_ns is not None:
        keep &= cols["answered"] > start_ns
    if end_ns is not None:
        keep &= cols["submitted"] < end_ns
    if engine is not None:
        keep &= cols["engine"] == engine
    return {k: v[keep] for k, v in cols.items()}
