"""Streaming folder dataset: lazy per-batch decode in a worker pool
(counterpart of ``scouter_tpu/data/streaming.py``).

The reference's DataLoader decodes per item in worker processes
(``train.py:159-160``; ``dataset/ConText.py:69-89``), so memory is O(batch),
not O(dataset). Here a thread pool reads the files of just the indices the
Loader asks for and decodes them (``data/_decode.py``: PNG on the host, JPEG
by nvJPEG on the card or Pillow on the CPU), staged to a fixed uint8 size on
the dataset's device; ``transforms.preprocess_batch`` still makes the exact
model input, so the numeric path is the eager loader's.

A byte-capped cache of staged images (2 GiB by default, the JAX package's
bound) keeps small datasets resident after the first epoch and bounds
memory on CUB- or ImageNet-scale trees. It lives on the dataset's device: on
the card the staged pixels are made there, and a batch gathered from the
cache is then not copied to the host and back. Decoding is a pure function
of the file's bytes, so a cached image equals a fresh decode.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Sequence

import numpy as np
import torch

from ..core.device import resolve_device
from ._decode import decode_file
from .folders import PathLabel

__all__ = ["FolderDataset"]

_POOL = None
_POOL_LOCK = threading.Lock()


def _shared_pool(workers: int) -> ThreadPoolExecutor:
    """One process-wide decode pool: CLIs build several FolderDatasets."""
    global _POOL
    with _POOL_LOCK:
        if _POOL is None:
            _POOL = ThreadPoolExecutor(max_workers=workers, thread_name_prefix="folder-decode")
        return _POOL


class _LazyImageView:
    """``.images[idx]`` of a FolderDataset, the surface ArrayDataset has
    (the explain CLI reads one vis image through it), decoding only the
    requested indices through ``FolderDataset.gather``."""

    def __init__(self, ds: "FolderDataset"):
        self._ds = ds

    def __len__(self) -> int:
        return len(self._ds)

    def __getitem__(self, index):
        if isinstance(index, (int, np.integer)):
            return self._ds.gather([int(index)])[0]
        if isinstance(index, slice):
            return self._ds.gather(np.arange(len(self._ds))[index])
        return self._ds.gather(np.asarray(index))


class FolderDataset:
    """Lazy directory-backed dataset with a bounded cache of staged images
    on ``device``."""

    def __init__(self, items: Sequence[PathLabel], staging_size: int, dataset_name: str,
                 cache_bytes: int = 2 << 30, workers: int = 8, device="cuda"):
        self.items = list(items)
        self.labels = np.asarray([label for _, label in self.items], np.int32)
        self.staging_size = staging_size
        self.dataset_name = dataset_name
        self.cache_bytes = cache_bytes
        self.device = resolve_device(device)
        self._item_bytes = staging_size * staging_size * 3
        self._cache: Dict[int, torch.Tensor] = {}
        self._cache_lock = threading.Lock()
        self._pool = _shared_pool(workers)

    def __len__(self) -> int:
        return len(self.items)

    @property
    def images(self) -> _LazyImageView:
        return _LazyImageView(self)

    @property
    def cached_bytes(self) -> int:
        return len(self._cache) * self._item_bytes

    def _decode(self, index: int) -> torch.Tensor:
        return decode_file(self.items[index][0], self.staging_size, self.device)

    def gather(self, indices) -> torch.Tensor:
        """Decode (or take from the cache) ``indices``: (B, s, s, 3) uint8 on
        the dataset's device."""
        indices = np.asarray(indices)
        s = self.staging_size
        out = torch.empty((len(indices), s, s, 3), dtype=torch.uint8, device=self.device)
        pending = []
        with self._cache_lock:
            for pos, idx in enumerate(indices):
                hit = self._cache.get(int(idx))
                if hit is not None:
                    out[pos] = hit
                else:
                    pending.append((pos, int(idx)))
        if pending:
            decoded = list(self._pool.map(lambda p: (p[0], p[1], self._decode(p[1])), pending))
            with self._cache_lock:
                for pos, idx, img in decoded:
                    out[pos] = img
                    if (idx not in self._cache
                            and self.cached_bytes + self._item_bytes <= self.cache_bytes):
                        self._cache[idx] = img
        return out
