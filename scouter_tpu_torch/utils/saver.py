"""Top-k checkpoint saver (counterpart of ``scouter_tpu/utils/saver.py``,
timm's ``CheckpointSaver``, ``timm/utils.py:35-151``): keep the N best
checkpoints by a metric, a ``model_best`` copy, and batch-level recovery
files.

A checkpoint is a payload dict written through
``core/checkpoint.py::save_on_master`` (``torch.save`` to a temporary file,
then a rename), with the port's ``.pth`` extension. Files are written and
removed by rank 0 only (``core/distributed.py::get_rank``).
"""

from __future__ import annotations

import glob
import operator
import os
from typing import Any, Dict, List, Optional, Tuple

from ..core.checkpoint import save_on_master
from ..core.distributed import get_rank

__all__ = ["CheckpointSaver"]


class CheckpointSaver:
    def __init__(self, checkpoint_dir: str, *, max_history: int = 10, decreasing: bool = False,
                 recovery_dir: Optional[str] = None):
        self.checkpoint_dir = checkpoint_dir
        self.recovery_dir = recovery_dir or checkpoint_dir
        self.max_history = max(1, max_history)
        self.decreasing = decreasing
        self.cmp = operator.lt if decreasing else operator.gt
        self.checkpoint_files: List[Tuple[str, float]] = []  # (path, metric), best first
        self.best_metric: Optional[float] = None
        self.best_epoch: Optional[int] = None
        os.makedirs(checkpoint_dir, exist_ok=True)

    def _worst(self) -> Optional[float]:
        return self.checkpoint_files[-1][1] if self.checkpoint_files else None

    def save_checkpoint(self, payload: Dict[str, Any], epoch: int,
                        metric: float) -> Optional[float]:
        """Store ``payload`` if it ranks in the top ``max_history``; returns
        the best metric. Evictions are rank-0 only, like the writes: a
        non-master rank must not delete checkpoints it never replaces."""
        worst = self._worst()
        if (len(self.checkpoint_files) < self.max_history or worst is None
                or self.cmp(metric, worst)):
            if len(self.checkpoint_files) >= self.max_history:
                path, _ = self.checkpoint_files.pop()
                if get_rank() == 0 and os.path.exists(path):
                    os.remove(path)
            path = os.path.join(self.checkpoint_dir, f"checkpoint-{epoch}.pth")
            if get_rank() == 0:
                save_on_master(payload, path)
            self.checkpoint_files.append((path, metric))
            self.checkpoint_files.sort(key=lambda x: x[1], reverse=not self.decreasing)
            if self.best_metric is None or self.cmp(metric, self.best_metric):
                self.best_metric, self.best_epoch = metric, epoch
                if get_rank() == 0:
                    save_on_master(payload, os.path.join(self.checkpoint_dir, "model_best.pth"))
        return self.best_metric

    def save_recovery(self, payload: Dict[str, Any], epoch: int, batch_idx: int) -> str:
        """Batch-level recovery file (timm/utils.py:130-140). Write, then
        clean, rank 0 only: deleting the old file first would leave a crash
        window with no recovery point at all."""
        path = os.path.join(self.recovery_dir, f"recovery-{epoch}-{batch_idx}.pth")
        if get_rank() != 0:
            return path
        save_on_master(payload, path)
        for old in glob.glob(os.path.join(self.recovery_dir, "recovery-*.pth")):
            if old != path:
                os.remove(old)
        return path

    def find_recovery(self) -> Optional[str]:
        files = sorted(glob.glob(os.path.join(self.recovery_dir, "recovery-*.pth")),
                       key=os.path.getmtime)
        return files[-1] if files else None
