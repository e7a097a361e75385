"""Open serving loop: requests sent on a schedule, whether or not earlier ones
have finished.

The schedule (``generator.arrivals``: Poisson at the cell's fixed
``rate_img_s``) covers a lead-in of ``lead_s`` seconds, whose
requests warm the engine up and are not counted, and the window; the host
thread sends each
request at its due time through the engine's ``submit`` and the answer's
time is taken when its future resolves. A request's latency runs from its
due time, so a stall counts against every request behind it; one that fails,
or has not come by the end of the grace after the window, counts as the
time from its due time to the later of the window's end and that moment.
``serve_p95_ms`` is the 95th percentile over every request due in the
window. How late the sender ran is printed on standard error.

The comparison takes a sample of ``sample`` requests drawn from the seed
before the window.
"""

from __future__ import annotations

import contextlib
import functools
import sys
import threading
import time

from typing import Dict

import numpy as np

from ..compare import serve_numbers
from ..generator import arrivals, picks
from ..harness import Ctx, Outcome, quiesce
from .serving import ServeRun, batch_fill, reference_answers, sampled

__all__ = ["run", "window"]


def window(srv: ServeRun, ctx: Ctx, seconds: float, tracer=None) -> Dict:
    """Send the seeded schedule of ``seconds`` through ``srv``'s engine and
    wait for its answers (module docstring)."""
    import torch

    from ..trace import WINDOW

    p = ctx.params
    engine = srv.engine
    lead = float(p["lead_s"])
    due = arrivals(p, lead + seconds, ctx.seed)
    n = len(due)
    first = int(np.searchsorted(due, lead))  # the lead-in's requests warm up
    img = picks(n, len(srv.pool), ctx.seed)
    keys = sorted((first + np.random.default_rng([ctx.seed % 2**63, 13]).choice(
        n - first, min(int(p["sample"]), n - first), replace=False)).tolist())
    want = set(keys)
    done = np.full(n, np.nan)
    ok = np.zeros(n, bool)
    answers = {}
    lock = threading.Lock()
    left = [n]
    all_done = threading.Event()
    if n == 0:
        all_done.set()

    def finish(i, fut):
        t = time.perf_counter()
        exc = fut.exception()
        with lock:
            done[i] = t
            ok[i] = exc is None
            if exc is None and i in want:
                answers[i] = {k: np.array(v) for k, v in fut.result().items()}
            left[0] -= 1
            if left[0] == 0:
                all_done.set()

    late = [0.0]

    def send(lo, hi):
        for i in range(lo, hi):
            delay = start + due[i] - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            else:
                late[0] = max(late[0], -delay)
            engine.submit(srv.pool[img[i]]).add_done_callback(functools.partial(finish, i))

    quiesce()
    start = time.perf_counter()
    t0 = start + lead
    send(0, first)
    before = engine.stats()
    with (tracer if tracer is not None else contextlib.nullcontext()):
        with (torch.profiler.record_function(WINDOW) if tracer is not None
              else contextlib.nullcontext()):
            send(first, n)
            rest = t0 + seconds - time.perf_counter()
            if rest > 0:
                time.sleep(rest)
            t_end = time.perf_counter()
    after = engine.stats()
    all_done.wait(float(p["grace_s"]))
    now = time.perf_counter()
    with lock:
        done_w, ok_w = done[first:], ok[first:]
        finished = ~np.isnan(done_w)
        stop = np.where(ok_w & finished, done_w,
                        np.maximum(t_end, np.where(finished, done_w, now)))
        lat = stop - (start + due[first:])
        in_time = int(np.sum(done_w <= t_end))
        got = dict(answers)
        failed = int((~ok_w).sum())
    print(f"gpubench: {n - first} requests due in {seconds} s after a {lead} s lead-in of "
          f"{first}; the sender ran at most {late[0] * 1e3:.3f} ms late", file=sys.stderr)
    return {"n": n - first, "t0": t0, "t_end": t_end, "lat": lat, "failed": failed,
            "keys": keys, "got": got, "img": img, "in_time": in_time,
            "fill": batch_fill(before, after)}


def run(ctx: Ctx) -> Outcome:
    import torch

    from ..trace import Tracer

    srv = ServeRun(ctx)
    seconds = min(ctx.seconds, float(ctx.params["trace_seconds"])) if ctx.trace else ctx.seconds
    tracer = Tracer() if ctx.trace else None
    try:
        w = window(srv, ctx, seconds, tracer)
        peak = (int(torch.cuda.max_memory_allocated(ctx.device)) if ctx.device.type == "cuda"
                else 0)
    finally:
        srv.close()
    pool = srv.pool
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    have = [k for k in w["keys"] if k in w["got"]]
    numbers = serve_numbers(sampled(w["got"], have), reference_answers(ctx, pool[w["img"][have]]))
    n = w["n"]
    return Outcome(
        e2e={"serve_p95_ms": float(np.percentile(w["lat"], 95)) * 1e3 if n else float("nan"),
             "setup_s": w["t0"] - ctx.t_start},
        attempted=n, failed=w["failed"], numbers=numbers, memory_peak_bytes=peak,
        window_s=w["t_end"] - w["t0"], trace=tracer.data if tracer is not None else None,
        layer={"batch_fill": w["fill"]}, answers_missing=len(w["keys"]) - len(have))
