"""Micro-batching inference engine (counterpart of ``scouter_tpu/serve/engine.py``).

- requests enter a queue (``submit`` returns a Future);
- a dispatcher thread drains up to the largest bucket, waiting at most
  ``max_wait_ms`` to let a batch form;
- the batch is padded to the smallest bucket that fits, run through the
  serving function (``make_serving_fn``), and its rows are handed back to
  the futures.

Dispatch is pipelined: CUDA launches return before the card finishes, so the
dispatcher hands the (device outputs, futures) pair to one of ``resolvers``
threads, which does the blocking device->host copy and sets the futures,
while the dispatcher forms the next batch. At most ``max_inflight`` batches
are dispatched and not yet fetched: the dispatcher takes a slot before it
dispatches and the resolver gives it back after the fetch.

Each request answered leaves a row in ``utils/tracing.py``'s request record
(its id, its batch's, five stamps on the profiler's clock), which
``stage_samples`` reads; while a profiler session runs, the dispatcher's and
resolvers' waits and host work show as ``engine.*`` spans.

With ``mesh=`` (``parallel/mesh.py::make_mesh``) each bucket batch is
split over the mesh's ``data`` devices in this process, each block served on
its device, and the rows joined again: what the unmeshed engine returns
(``scouter_tpu/serve/engine.py:54-95``). Every bucket must divide the mesh's
device count. A mesh of the world's ranks serves on this process's own
device; on one card the mesh is that card.

Two races of the JAX engine are not carried over: ``submit``'s close-race
path fails only requests still in the request queue (it never touches the
resolvers' queue, so it cannot eat their shutdown sentinels), and the
in-flight bound counts batches held by resolvers too.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, Sequence

import numpy as np
import torch

from ..core.device import resolve_device
from ..utils import tracing
from ..utils.tracing import span
from .export import make_serving_fn

__all__ = ["InferenceEngine"]


def _host(v) -> np.ndarray:
    return v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def _split_over(fns):
    """A serving function that runs block i of a batch's rows through
    ``fns[i]`` and joins the outputs row-wise (on the first block's device)."""
    n = len(fns)

    def join(parts):
        if torch.is_tensor(parts[0]):
            return torch.cat([p.to(parts[0].device) for p in parts])
        return np.concatenate(parts)

    def serve(images_u8):
        rows = images_u8.shape[0] // n
        outs = [fn(images_u8[i * rows:(i + 1) * rows]) for i, fn in enumerate(fns)]
        return outs[0] if n == 1 else {k: join([o[k] for o in outs]) for k in outs[0]}

    return serve


class InferenceEngine:
    def __init__(
        self,
        cfg,
        state_dict,
        *,
        buckets: Sequence[int] = (1, 4, 16),
        max_wait_ms: float = 2.0,
        compute_dtype=None,
        include_maps: bool = True,
        max_inflight: int = 8,
        quant=None,
        resolvers: int = 4,
        device="cuda",
        mesh=None,
    ):
        """mesh: serve data-parallel over its ``data`` axis (see the module
        docstring); every bucket size must divide the mesh's device count.

        max_inflight: batches dispatched and not yet fetched before the
        dispatcher blocks (pipelining depth; 1 = fully serial).
        quant: a ``serve/quant.py`` policy name ('int8'), installed on the
        served model, so the dispatcher thread serves it.
        resolvers: threads doing the device->host fetch and resolving futures."""
        self.cfg = cfg
        channels = 1 if cfg.dataset == "MNIST" else 3
        self._img_shape = (cfg.img_size, cfg.img_size, channels)
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError("buckets must be positive ints")
        self.max_wait_s = max_wait_ms / 1e3
        self.device = resolve_device(device)
        if mesh is None:
            self._fn = make_serving_fn(cfg, state_dict, compute_dtype=compute_dtype,
                                       include_maps=include_maps, quant=quant, device=device)
        else:
            n = int(mesh.devices.size)
            bad = [b for b in self.buckets if b % n]
            if bad:
                raise ValueError(f"buckets {bad} not divisible by the {n}-device mesh")
            devices, fns = self._data_devices(mesh), {}
            for dev in devices:
                if dev not in fns:
                    fns[dev] = make_serving_fn(cfg, state_dict, compute_dtype=compute_dtype,
                                               include_maps=include_maps, quant=quant,
                                               device=dev)
            self._fn = _split_over([fns[d] for d in devices])
        self._queue: "queue.Queue" = queue.Queue()
        # bucket_fill["b/n"] counts batches that ran bucket b carrying n live images
        self._stats = {"requests": 0, "batches": 0, "padded": 0, "bucket_fill": {}}
        self._id = tracing.new_id()  # this engine's rows in the request record
        self._lock = threading.Lock()
        self._closed = threading.Event()
        self._max_inflight = max(1, max_inflight)
        self._n_inflight = 0
        self._slot_free = threading.Condition(self._lock)
        self._inflight: "queue.Queue" = queue.Queue()
        self._resolvers = [threading.Thread(target=self._resolve_loop, daemon=True)
                           for _ in range(max(1, resolvers))]
        for t in self._resolvers:
            t.start()
        self._thread = threading.Thread(target=self._dispatch_loop, daemon=True)
        self._thread.start()

    def _data_devices(self, mesh):
        """The device of each ``data`` index (the ``model`` axis replicates)."""
        from ..core.distributed import get_rank

        line = mesh.devices.reshape(mesh.size("data"), -1)[:, 0]
        out = []
        for d in line:
            if isinstance(d, (int, np.integer)):
                if int(d) != get_rank():
                    raise ValueError(f"rank {int(d)} of the mesh is another process: an "
                                     "engine serves on the devices of its own process")
                out.append(self.device)
            else:
                out.append(resolve_device(d))
        return out

    # -- public API ---------------------------------------------------------

    def submit(self, image_u8: np.ndarray) -> Future:
        """Enqueue one (img_size, img_size, C) uint8 image; resolves to a dict
        with 'logits' (num_classes,) and, if enabled, 'slot_maps'."""
        if self._closed.is_set():
            raise RuntimeError("engine is closed")
        image_u8 = self._validate(np.asarray(image_u8), batched=False)
        fut: Future = Future()
        self._queue.put((image_u8, fut, tracing.now_ns(), tracing.new_id()))
        if self._closed.is_set():
            # close() raced us past the check above: fail what is still queued
            # so this request cannot strand; the resolvers' queue is not ours
            self._fail_queued()
        return fut

    def infer_batch(self, images_u8: np.ndarray) -> Dict[str, np.ndarray]:
        """Synchronous whole-batch path (bypasses the queue); batches larger
        than the biggest bucket are split into bucket-sized chunks."""
        images_u8 = self._validate(np.asarray(images_u8), batched=True)
        n = images_u8.shape[0]
        max_b = self.buckets[-1]
        outs = []
        for s in range(0, n, max_b):
            out = self._dispatch_padded(images_u8[s:s + max_b])
            outs.append({k: _host(v) for k, v in out.items()})
        return {k: np.concatenate([o[k] for o in outs])[:n] for k in outs[0]}

    def stats(self) -> Dict:
        with self._lock:
            out = dict(self._stats)
            out["bucket_fill"] = dict(self._stats["bucket_fill"])
            return out

    def stage_samples(self):
        """Per-request stage timings of this engine's requests still in the
        request record, oldest first, in seconds: ``queue_wait`` (submit ->
        batch formed, an in-flight slot held), ``dispatch`` (the serving
        call), ``inflight_wait`` (dispatched -> resolver pickup), ``fetch``
        (device finish + device->host copy); with the batch's ``live`` rows
        and ``bucket``, and the ``request`` and ``batch`` ids."""
        r = tracing.records(engine=self._id)
        cols = {"queue_wait": (r["formed"] - r["submitted"]) * 1e-9,
                "dispatch": (r["launched"] - r["formed"]) * 1e-9,
                "inflight_wait": (r["picked"] - r["launched"]) * 1e-9,
                "fetch": (r["answered"] - r["picked"]) * 1e-9,
                **{k: r[k] for k in ("live", "bucket", "request", "batch")}}
        return [dict(zip(cols, row)) for row in zip(*(c.tolist() for c in cols.values()))]

    def close(self):
        self._closed.set()
        self._queue.put(None)  # wake the dispatcher
        # the sentinels below must follow the dispatcher's last batch
        self._thread.join(timeout=600)
        for _ in self._resolvers:
            self._inflight.put(None)
        for t in self._resolvers:
            t.join(timeout=60)
        self._fail_queued()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- internals ----------------------------------------------------------

    def _validate(self, arr: np.ndarray, *, batched: bool) -> np.ndarray:
        """Require raw uint8 pixels of the configured geometry: a uint8 cast
        would truncate normalised float images to garbage."""
        if arr.dtype != np.uint8:
            raise TypeError(
                f"expected uint8 raw pixels (normalization happens inside the "
                f"serving function), got dtype {arr.dtype}")
        want = self._img_shape
        got = arr.shape[1:] if batched else arr.shape
        if got != want:
            raise ValueError(f"expected image shape {want}, got {got}")
        return arr

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise AssertionError(f"internal: batch {n} exceeds largest bucket {self.buckets[-1]}")

    def _dispatch_padded(self, images_u8):
        """Stack (an array or a list of images), pad to the bucket and run
        the serving function; returns device outputs (the card may still be
        computing them)."""
        n = len(images_u8)
        bucket = self._bucket_for(n)
        with span("engine.stage"):
            if not isinstance(images_u8, np.ndarray):
                images_u8 = np.stack(images_u8)
            if n < bucket:
                pad = np.zeros((bucket - n,) + images_u8.shape[1:], np.uint8)
                images_u8 = np.concatenate([images_u8, pad], axis=0)
        out = self._fn(images_u8)
        with self._lock:
            self._stats["batches"] += 1
            self._stats["padded"] += bucket - n
            key = f"{bucket}/{n}"
            self._stats["bucket_fill"][key] = self._stats["bucket_fill"].get(key, 0) + 1
        return out

    def _take_slot(self):
        with span("engine.slot"), self._slot_free:
            while self._n_inflight >= self._max_inflight:
                self._slot_free.wait()
            self._n_inflight += 1

    def _give_slot(self):
        with self._slot_free:
            self._n_inflight -= 1
            self._slot_free.notify()

    def _saturated(self) -> bool:
        with self._lock:
            return self._n_inflight >= self._max_inflight

    def _fail_queued(self):
        """Fail requests that were queued but never dispatched."""
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                return
            if item is not None and item[1].set_running_or_notify_cancel():
                item[1].set_exception(RuntimeError("engine is closed"))

    def _dispatch_loop(self):
        max_bucket = self.buckets[-1]
        while True:
            try:
                with span("engine.await"):
                    item = self._queue.get(timeout=0.1)
            except queue.Empty:
                if self._closed.is_set():
                    return
                continue
            if item is None:
                if self._queue.empty():
                    return
                continue
            with span("engine.form"):
                batch = [item]
                deadline = time.monotonic() + self.max_wait_s
                while len(batch) < max_bucket:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 and not self._saturated():
                        break  # window elapsed and the card has room: dispatch
                    try:
                        # while max_inflight batches are out, waiting to fill
                        # the bucket costs nothing: a partial batch would only
                        # spend a dispatch on padding
                        nxt = self._queue.get(
                            timeout=remaining if remaining > 0 else self.max_wait_s)
                    except queue.Empty:
                        if self._saturated():
                            continue
                        break
                    if nxt is None:
                        break
                    batch.append(nxt)
                # drop client-cancelled requests; mark the rest running so a
                # late cancel() can no longer make set_result raise
                live = [b for b in batch if b[1].set_running_or_notify_cancel()]
                with self._lock:
                    self._stats["requests"] += len(live)
            if not live:
                continue
            self._take_slot()
            try:
                t_formed = tracing.now_ns()
                out = self._dispatch_padded([b[0] for b in live])
                self._inflight.put((out, live, tracing.new_id(), t_formed, tracing.now_ns()))
            except Exception as exc:  # resolve, never hang callers
                self._give_slot()
                for _, fut, _t, _r in live:
                    fut.set_exception(exc)

    def _resolve_loop(self):
        """Fetch dispatched batches to the host, record them and resolve
        their futures."""
        while True:
            with span("engine.pick"):
                item = self._inflight.get()
            if item is None:
                return
            out, live, batch, t_formed, t_launched = item
            t_pick = tracing.now_ns()
            try:
                with span("engine.fetch", batch=batch):
                    host = {k: _host(v) for k, v in out.items()}
            except Exception as exc:
                for _, fut, _t, _r in live:
                    fut.set_exception(exc)
                continue
            finally:
                self._give_slot()
            # record before resolving: a caller woken by the last set_result
            # may read stage_samples() at once
            tracing.record_batch(self._id, batch, [b[3] for b in live], [b[2] for b in live],
                                 t_formed, t_launched, t_pick, tracing.now_ns(),
                                 int(host["logits"].shape[0]))
            with span("engine.resolve", batch=batch):
                for i, (_, fut, _t, _r) in enumerate(live):
                    fut.set_result({k: v[i] for k, v in host.items()})
