"""Pointing-game benchmark, the explanation-accuracy metric (counterpart of
``scouter_tpu/explain/pointing_game.py``, which holds no JAX: a copy, so
that the port imports nothing of the JAX package;
``torchray/benchmark/pointing_game.py:35-221`` capability).

A predicted point hits if a disc of radius ``tolerance`` around it intersects
the ground-truth occupancy mask; per-class accuracies average hits over
hits+misses. ``PointingGameBenchmark`` adds the EBP difficult-subset gating
(:129-221): a per-image/class flag table (``load_difficult_flags``, same
tab-separated format as torchray's ``pointing_game_ebp_*_difficult.txt``)
skips easy pairs, and items whose ground-truth boxes are all PASCAL-difficult
evaluate to 0 (skipped).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = [
    "PointingGame",
    "PointingGameBenchmark",
    "load_difficult_flags",
    "saliency_point",
]


def saliency_point(saliency: np.ndarray) -> Tuple[int, int]:
    """argmax location of a (H, W) saliency map as (u, v) = (x, y)."""
    idx = int(np.argmax(saliency))
    h, w = saliency.shape
    return idx % w, idx // w


class PointingGame:
    def __init__(self, num_classes: int, tolerance: int = 15):
        self.num_classes = num_classes
        self.tolerance = tolerance
        self.hits = np.zeros(num_classes, np.float64)
        self.misses = np.zeros(num_classes, np.float64)

    def evaluate(self, mask: np.ndarray, point: Tuple[int, int]) -> int:
        """mask: {0,1} (H, W); point: (u, v). Returns +1 hit / -1 miss."""
        h, w = mask.shape
        yy = (np.arange(h, dtype=np.float32) - point[1]) ** 2
        xx = (np.arange(w, dtype=np.float32) - point[0]) ** 2
        accept = (yy[:, None] + xx[None, :]) < self.tolerance**2
        hit = bool(np.any(np.logical_and(mask.astype(bool), accept)))
        return 1 if hit else -1

    def aggregate(self, hit: int, class_id: int) -> None:
        if hit == 1:
            self.hits[class_id] += 1
        elif hit == -1:
            self.misses[class_id] += 1

    def reset(self) -> None:
        self.hits[:] = 0
        self.misses[:] = 0

    @property
    def class_accuracies(self) -> np.ndarray:
        return self.hits / np.clip(self.hits + self.misses, 1, None)

    @property
    def accuracy(self) -> float:
        return float(self.class_accuracies.mean())

    def __str__(self) -> str:
        accs = self.class_accuracies
        per = " ".join(f"{c}:{100 * a:4.1f}%" for c, a in enumerate(accs))
        return f"{100 * accs.mean():4.1f}% [{per}]"


def load_difficult_flags(path: str) -> Dict[str, List[bool]]:
    """Parse a difficult-subset flag table (pointing_game.py:156-170 format):
    one row per image, tab-separated ``name flag_0 ... flag_{C-1}``."""
    flags: Dict[str, List[bool]] = {}
    with open(path) as f:
        for row in f:
            cells = row.rstrip("\n").split("\t")
            if cells and cells[0]:
                flags[cells[0]] = [bool(int(x)) for x in cells[1:]]
    return flags


class PointingGameBenchmark(PointingGame):
    """PointingGame + difficult-subset gating (pointing_game.py:129-221).

    ``difficult_flags``: optional per-image/class table from
    ``load_difficult_flags``; when set, (image, class) pairs flagged easy —
    or images absent from the table — still evaluate, matching the reference
    (only pairs explicitly flagged ``False`` are skipped, :188-197).
    """

    def __init__(self, num_classes: int, tolerance: int = 15,
                 difficult_flags: Optional[Dict[str, List[bool]]] = None):
        super().__init__(num_classes=num_classes, tolerance=tolerance)
        self.difficult_flags = difficult_flags

    def evaluate_item(
        self,
        image_name: str,
        class_id: int,
        mask: Optional[np.ndarray],
        point: Tuple[int, int],
        all_gt_difficult: bool = False,
    ) -> int:
        """+1 hit / -1 miss / 0 skipped.

        Skips when the difficult table flags the pair easy, or when every
        ground-truth box of the class is PASCAL-difficult (mask is None or
        ``all_gt_difficult`` — the :204-211 rule).
        """
        if self.difficult_flags is not None:
            flags = self.difficult_flags.get(image_name)
            if flags is not None and not flags[class_id]:
                return 0
        if mask is None or all_gt_difficult:
            return 0
        return self.evaluate(mask, point)
