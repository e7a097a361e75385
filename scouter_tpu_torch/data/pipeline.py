"""Host data pipeline: shuffling, batching, device transfer and prefetch
(counterpart of ``scouter_tpu/data/pipeline.py``, one process).

Replaces the reference's DataLoader stack (``train.py:152-160``: sampler,
BatchSampler(drop_last=True), DataLoaderX thread prefetch):

- the per-epoch shuffle is ``np.random.RandomState((seed*100003 + epoch) %
  2**31)``, the JAX package's, so both visit the same samples in the same
  order (``set_epoch`` parity, ``train.py:176-177``)
- train batches drop the remainder (``train.py:158``); val keeps it: the
  trailing partial batch is padded to the batch size with the first item
  and carries a validity ``mask``
- host batches are uint8, pinned on the card's host side and copied
  asynchronously; ``preprocess_batch`` resizes, augments and normalises them
  on the device. The next batch's copy and preprocessing are enqueued before
  the current batch is handed out, one batch ahead, as the JAX thread does.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np
import torch

from ..core.device import resolve_device
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
                 train: bool, aug: bool = False, seed: int = 0, device="cuda"):
        self.ds = dataset
        self.batch_size = batch_size
        self.img_size = img_size
        self.train = train
        self.aug = aug
        self.seed = seed
        self.device = resolve_device(device)
        self._indices = np.arange(len(dataset))

    def steps_per_epoch(self) -> int:
        n = len(self._indices)
        return n // self.batch_size if self.train else -(-n // self.batch_size)

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        idx = self._indices
        if self.train:
            rng = np.random.RandomState((self.seed * 100003 + epoch) % (2**31))
            idx = idx.copy()
            rng.shuffle(idx)
            idx = idx[: (len(idx) // self.batch_size) * self.batch_size]
        return idx

    def _host_batches(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
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
            yield {"image": self.ds.images[chunk], "label": self.ds.labels[chunk],
                   "mask": mask}

    def _aug_generator(self, epoch: int, batch_index: int) -> Optional[torch.Generator]:
        if not (self.train and self.aug):
            return None
        base = (self.seed * 7919 + epoch) % (2**31)
        return torch.Generator().manual_seed(base * 1_000_003 + batch_index)

    def _to_device(self, host: Dict[str, np.ndarray], batch_index: int, epoch: int):
        pin = self.device.type == "cuda"
        out = {}
        for key, dtype in (("image", torch.uint8), ("label", torch.int64),
                           ("mask", torch.float32)):
            t = torch.from_numpy(np.ascontiguousarray(host[key])).to(dtype)
            if pin:
                t = t.pin_memory()
            out[key] = t.to(self.device, non_blocking=pin)
        x = preprocess_batch(out["image"], dataset=self.ds.dataset_name,
                             img_size=self.img_size, train=self.train, aug=self.aug,
                             generator=self._aug_generator(epoch, batch_index))
        out["image"] = x.permute(0, 3, 1, 2).contiguous()
        return out

    def epoch(self, epoch: int) -> Iterator[Dict[str, torch.Tensor]]:
        """Yield the device batches of one epoch, one batch ahead."""
        host = self._host_batches(epoch)
        first = next(host, None)
        if first is None:
            return
        ahead = self._to_device(first, 0, epoch)
        for bi, hb in enumerate(host, start=1):
            current, ahead = ahead, self._to_device(hb, bi, epoch)
            yield current
        yield ahead
