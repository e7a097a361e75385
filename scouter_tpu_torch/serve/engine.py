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

Two races of the JAX engine are not carried over: ``submit``'s close-race
path fails only requests still in the request queue (it never touches the
resolvers' queue, so it cannot eat their shutdown sentinels), and the
in-flight bound counts batches held by resolvers too.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, Sequence

import numpy as np
import torch

from ..core.device import resolve_device
from .export import make_serving_fn

__all__ = ["InferenceEngine"]


def _host(v) -> np.ndarray:
    return v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


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
    ):
        """max_inflight: batches dispatched and not yet fetched before the
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
        self._fn = make_serving_fn(cfg, state_dict, compute_dtype=compute_dtype,
                                   include_maps=include_maps, quant=quant, device=device)
        self.device = resolve_device(device)
        self._queue: "queue.Queue" = queue.Queue()
        # bucket_fill["b/n"] counts batches that ran bucket b carrying n live images
        self._stats = {"requests": 0, "batches": 0, "padded": 0, "bucket_fill": {}}
        # per-request stage samples (seconds): queue_wait (submit -> batch
        # formed), dispatch (the serving call), inflight_wait (dispatched ->
        # resolver pickup), fetch (device finish + device->host copy)
        self._samples: "collections.deque" = collections.deque(maxlen=8192)
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

    # -- public API ---------------------------------------------------------

    def submit(self, image_u8: np.ndarray) -> Future:
        """Enqueue one (img_size, img_size, C) uint8 image; resolves to a dict
        with 'logits' (num_classes,) and, if enabled, 'slot_maps'."""
        if self._closed.is_set():
            raise RuntimeError("engine is closed")
        image_u8 = self._validate(np.asarray(image_u8), batched=False)
        fut: Future = Future()
        self._queue.put((image_u8, fut, time.monotonic()))
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
        """Per-request engine stage timings (see ``_samples`` above)."""
        with self._lock:
            return list(self._samples)

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

    def _dispatch_padded(self, images_u8: np.ndarray):
        """Pad to the bucket and run the serving function; returns device
        outputs (the card may still be computing them)."""
        n = images_u8.shape[0]
        bucket = self._bucket_for(n)
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
        with self._slot_free:
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
                item = self._queue.get(timeout=0.1)
            except queue.Empty:
                if self._closed.is_set():
                    return
                continue
            if item is None:
                if self._queue.empty():
                    return
                continue
            batch = [item]
            deadline = time.monotonic() + self.max_wait_s
            while len(batch) < max_bucket:
                remaining = deadline - time.monotonic()
                if remaining <= 0 and not self._saturated():
                    break  # window elapsed and the card has room: dispatch
                try:
                    # while max_inflight batches are out, waiting to fill the
                    # bucket costs nothing: a partial batch would only spend a
                    # dispatch on padding
                    nxt = self._queue.get(timeout=remaining if remaining > 0 else self.max_wait_s)
                except queue.Empty:
                    if self._saturated():
                        continue
                    break
                if nxt is None:
                    break
                batch.append(nxt)
            # drop client-cancelled requests; mark the rest running so a late
            # cancel() can no longer make set_result raise
            live = [b for b in batch if b[1].set_running_or_notify_cancel()]
            if not live:
                continue
            with self._lock:
                self._stats["requests"] += len(live)
            self._take_slot()
            try:
                t_formed = time.monotonic()
                out = self._dispatch_padded(np.stack([b[0] for b in live]))
                self._inflight.put((out, live, (t_formed, time.monotonic())))
            except Exception as exc:  # resolve, never hang callers
                self._give_slot()
                for _, fut, _t in live:
                    fut.set_exception(exc)

    def _resolve_loop(self):
        """Fetch dispatched batches to the host and resolve their futures."""
        while True:
            item = self._inflight.get()
            if item is None:
                return
            out, live, (t_formed, t_disp) = item
            t_pick = time.monotonic()
            try:
                host = {k: _host(v) for k, v in out.items()}
            except Exception as exc:
                for _, fut, _t in live:
                    fut.set_exception(exc)
                continue
            finally:
                self._give_slot()
            t_done = time.monotonic()
            # record before resolving: a caller woken by the last set_result
            # may read stage_samples() at once
            with self._lock:
                for _, _fut, t_sub in live:
                    self._samples.append({
                        "queue_wait": t_formed - t_sub,
                        "dispatch": t_disp - t_formed,
                        "inflight_wait": t_pick - t_disp,
                        "fetch": t_done - t_pick,
                        "live": len(live),
                        "bucket": int(host["logits"].shape[0]),
                    })
            for i, (_, fut, _t) in enumerate(live):
                fut.set_result({k: v[i] for k, v in host.items()})
