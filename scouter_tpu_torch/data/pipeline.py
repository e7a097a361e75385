"""Host data pipeline: shuffling, batching, host sharding, device transfer
and prefetch (counterpart of ``scouter_tpu/data/pipeline.py``).

Replaces the reference's DataLoader stack (``train.py:152-160``: sampler,
BatchSampler(drop_last=True), DataLoaderX thread prefetch):

- the per-epoch shuffle is ``np.random.RandomState((seed*100003 + epoch) %
  2**31)``, the JAX package's, so both visit the same samples in the same
  order (``set_epoch`` parity, ``train.py:176-177``)
- train batches drop the remainder (``train.py:158``); val keeps it: the
  trailing partial batch is padded to the batch size with the first item
  and carries a validity ``mask``
- a batch's images come from the dataset's ``gather`` where it has one
  (``streaming.FolderDataset``, whose batches may already be on the card),
  else from a uint8 store through the host stager's ``gather_items``, as the
  JAX package's ``_host_batches`` does
- host batches are uint8, pinned on the card's host side and copied
  asynchronously; a batch already on the Loader's device is taken as it is.
  ``preprocess_batch`` resizes, augments and normalises them on the device.
- a producer thread makes the batches (the dataset's decode, the copy and
  the preprocessing) into a queue of ``prefetch`` batches, as the JAX
  package's Loader does (``scouter_tpu/data/pipeline.py:202-229``); an
  early break or an exception on either side stops it. On the card it
  enqueues its work on a stream of its own and records an event after
  each batch, which the consumer's stream waits on before the batch is
  used; each batch tensor is marked as used on the consumer's stream, so
  the allocator does not hand its memory back to the producer's too soon.
  While a profiler session runs, the consumer's wait for a batch shows as a
  ``loader.wait`` span and the producer's host gather and pinning of one as
  ``loader.gather`` (``utils/tracing.py``).
  Which batches an epoch holds, and in which order, does not depend on the
  thread: every batch is a function of (epoch, index) alone.
- several processes (``shard_by_host``, the JAX package's multi-process
  rules, ``pipeline.py:71-91, 100-145``): each data rank (the mesh's
  ``data`` coordinate, or the process's rank without a mesh) reads a
  contiguous shard (``parallel/mesh.py::host_shard_bounds``, the
  DistributedSampler's place); a train epoch takes this rank's slice of one
  global permutation, truncated to the smallest shard's full batches, and
  val shards are padded with fully masked batches, so that every rank runs
  the same number of steps. ``--batch_size`` is per process (the global
  batch is the data ranks times it), and with ``--aug`` a rank's draws are
  those its rows would get in the global batch.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from ..core import distributed
from ..core.device import resolve_device
from ..parallel.mesh import host_shard_bounds
from ..utils.tracing import span
from .native_stager import gather_items
from .transforms import preprocess_batch

__all__ = ["ArrayDataset", "Loader"]


class ArrayDataset:
    """In-memory array-backed dataset: uint8 (N, H, W, C) images, labels."""

    def __init__(self, images: np.ndarray, labels: np.ndarray, dataset_name: str):
        if len(images) != len(labels):
            raise ValueError(f"{len(images)} images but {len(labels)} labels")
        self.images = images
        self.labels = np.asarray(labels, np.int32)
        self.dataset_name = dataset_name

    def __len__(self):
        return len(self.images)


class Loader:
    """Batched loader with per-epoch deterministic shuffling and device
    preprocessing. Batches are dicts of ``image`` (B, C, H, W) float32,
    ``label`` (B,) int64 and ``mask`` (B,) float32 on ``device``."""

    def __init__(self, dataset: ArrayDataset, batch_size: int, *, img_size: int,
                 train: bool, aug: bool = False, seed: int = 0, shard_by_host: bool = True,
                 mesh=None, prefetch: int = 2, device="cuda"):
        if prefetch < 1:
            raise ValueError(f"prefetch must be at least 1, got {prefetch}")
        self.ds = dataset
        self.prefetch = prefetch
        self.batch_size = batch_size
        self.img_size = img_size
        self.train = train
        self.aug = aug
        self.seed = seed
        self.device = resolve_device(device)
        # this process's data rank and the number of data ranks
        if mesh is not None:
            self._shard = (mesh.coords().get("data", 0), mesh.size("data"))
        else:
            self._shard = (distributed.get_rank(), distributed.get_world_size())
        pi, pc = self._shard if shard_by_host else (0, 1)
        start, stop = host_shard_bounds(len(dataset), process_index=pi, process_count=pc)
        self._indices = np.arange(start, stop)
        self._shard_bounds = (start, stop)
        self._global_n = len(dataset)
        self._multi = pc > 1
        if self._multi:
            # every rank runs as many steps, or a collective of the step waits
            # forever: train truncates to the smallest shard's full batches,
            # val pads up to the largest shard's
            base, rem = divmod(len(dataset), pc)
            self._train_steps = base // batch_size
            self._val_steps = -(-(base + (1 if rem else 0)) // batch_size)
        self._stream = None  # the producer's CUDA stream, made at the first epoch

    def steps_per_epoch(self) -> int:
        if self._multi:
            return self._train_steps if self.train else self._val_steps
        n = len(self._indices)
        return n // self.batch_size if self.train else -(-n // self.batch_size)

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        idx = self._indices
        if self.train:
            rng = np.random.RandomState((self.seed * 100003 + epoch) % (2**31))
            if self._multi:
                # one global permutation a epoch, the same on every rank; each
                # takes its slice (DistributedSampler, train.py:152-154)
                start, stop = self._shard_bounds
                idx = rng.permutation(self._global_n)[start:stop]
            else:
                idx = idx.copy()
                rng.shuffle(idx)
            idx = idx[: (len(idx) // self.batch_size) * self.batch_size]
        return idx

    def _host_batches(self, epoch: int) -> Iterator[Dict[str, object]]:
        idx = self._epoch_indices(epoch)
        fill = idx[:1] if len(idx) else np.zeros(1, np.int64)
        for step_i in range(self.steps_per_epoch()):
            chunk = idx[step_i * self.batch_size:(step_i + 1) * self.batch_size]
            valid = len(chunk)
            if valid < self.batch_size:
                # pad the trailing eval batch to the full batch size; the
                # metrics mask the padding out
                chunk = np.concatenate([chunk, fill.repeat(self.batch_size - valid)])
            mask = np.zeros(self.batch_size, np.float32)
            mask[:valid] = 1.0
            if hasattr(self.ds, "gather"):
                image = self.ds.gather(chunk)
            elif self.ds.images.dtype == np.uint8:
                image = gather_items(self.ds.images, chunk)
            else:
                image = self.ds.images[chunk]
            yield {"image": image, "label": self.ds.labels[chunk], "mask": mask}

    def _aug_generator(self, epoch: int, batch_index: int) -> Optional[torch.Generator]:
        if not (self.train and self.aug):
            return None
        base = (self.seed * 7919 + epoch) % (2**31)
        return torch.Generator().manual_seed(base * 1_000_003 + batch_index)

    def _pinned(self, host: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """A host batch as tensors of the batch's dtypes, pinned for the
        card (a tensor already on a device is left there)."""
        pin = self.device.type == "cuda"
        out = {}
        for key, dtype in (("image", torch.uint8), ("label", torch.int64),
                           ("mask", torch.float32)):
            t = host[key]
            t = (t if torch.is_tensor(t) else torch.from_numpy(np.ascontiguousarray(t))).to(dtype)
            out[key] = t.pin_memory() if pin and t.device.type == "cpu" else t
        return out

    def _to_device(self, host: Dict[str, np.ndarray], batch_index: int, epoch: int):
        return self._upload(self._pinned(host), batch_index, epoch)

    def _upload(self, pinned: Dict[str, torch.Tensor], batch_index: int, epoch: int):
        """Copy a pinned batch to the device and preprocess it there."""
        pin = self.device.type == "cuda"
        out = {k: t.to(self.device, non_blocking=pin)  # no copy if already there
               for k, t in pinned.items()}
        rank, ranks = self._shard if self._multi else (0, 1)
        x = preprocess_batch(out["image"], dataset=self.ds.dataset_name,
                             img_size=self.img_size, train=self.train, aug=self.aug,
                             generator=self._aug_generator(epoch, batch_index),
                             rows=(rank * self.batch_size, ranks * self.batch_size))
        out["image"] = x.permute(0, 3, 1, 2).contiguous()
        return out

    def epoch(self, epoch: int) -> Iterator[Dict[str, torch.Tensor]]:
        """Yield the device batches of one epoch, made ``prefetch`` ahead on
        the producer thread."""
        cuda = self.device.type == "cuda"
        if cuda and self._stream is None:
            # one producer stream for the Loader's life: its allocator pool
            # stays warm from epoch to epoch
            self._stream = torch.cuda.Stream(self.device)
        stream = self._stream
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        cancel = threading.Event()
        # the producer makes exactly the epoch's steps (_host_batches yields
        # one a step), so the consumer takes that many items and no end mark
        steps = self.steps_per_epoch()

        def qput(item) -> bool:
            # a bounded put that gives up once the consumer has left the
            # epoch (an early break or an exception), so the thread ends and
            # releases its batches
            while not cancel.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            host = self._host_batches(epoch)
            for bi in range(steps):
                with span("loader.gather"):
                    pinned = self._pinned(next(host))
                batch = self._upload(pinned, bi, epoch)
                ready = None
                if cuda:
                    ready = torch.cuda.Event()
                    ready.record(stream)
                if not qput((batch, ready)):
                    return

        def worker():
            try:
                if cuda:
                    with torch.cuda.device(self.device), torch.cuda.stream(stream):
                        produce()
                else:
                    produce()
            except BaseException as exc:  # hand it over, never leave q.get waiting
                qput(exc)

        thread = threading.Thread(target=worker, name="loader-producer", daemon=True)
        thread.start()
        try:
            for _ in range(steps):
                with span("loader.wait"):
                    item = q.get()
                if isinstance(item, BaseException):
                    raise item
                batch, ready = item
                if ready is not None:
                    consumer = torch.cuda.current_stream(self.device)
                    consumer.wait_event(ready)
                    for t in batch.values():
                        t.record_stream(consumer)
                yield batch
        finally:
            cancel.set()
            while True:  # release the queued batches
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            thread.join()
