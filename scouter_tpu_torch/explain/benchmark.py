"""Attribution benchmark infrastructure (counterpart of
``scouter_tpu/explain/benchmark.py``; the capability of ``torchray/benchmark/``:
pointing game, experiment logging, dataset plumbing).

- :class:`ExperimentStore` replaces the MongoDB experiment logging
  (``torchray/benchmark/logging.py:39-168``) with a dependency-free sqlite
  store keyed by (series, experiment, item-id), storing JSON payloads —
  same get/set/list semantics, no server to launch.
- :func:`run_pointing_benchmark` drives a saliency method over a dataset of
  (image, class, mask) triples and aggregates with
  :class:`~scouter_tpu_torch.explain.pointing_game.PointingGame` — the harness the
  reference vendors (``pointing_game.py:129-221``) but never calls.
- Ground-truth masks come from any iterable; a VOC/COCO-style adapter is a thin
  function from annotations to boolean masks (torchray/benchmark/datasets.py
  capability without the torchvision dependency).
"""

from __future__ import annotations

import json
import os
import sqlite3
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from ._resize import resize_bilinear
from .pointing_game import PointingGame, saliency_point

__all__ = ["ExperimentStore", "run_pointing_benchmark"]


class ExperimentStore:
    """sqlite-backed experiment result store (MongoDB-logging replacement)."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.conn = sqlite3.connect(path)
        self.conn.execute(
            "CREATE TABLE IF NOT EXISTS results ("
            "series TEXT, experiment TEXT, item TEXT, payload TEXT,"
            "PRIMARY KEY (series, experiment, item))"
        )

    def save(self, series: str, experiment: str, item: str, payload: Dict) -> None:
        self.conn.execute(
            "INSERT OR REPLACE INTO results VALUES (?, ?, ?, ?)",
            (series, experiment, item, json.dumps(payload)),
        )
        self.conn.commit()

    def load(self, series: str, experiment: str, item: str) -> Optional[Dict]:
        cur = self.conn.execute(
            "SELECT payload FROM results WHERE series=? AND experiment=? AND item=?",
            (series, experiment, item),
        )
        row = cur.fetchone()
        return json.loads(row[0]) if row else None

    def keys(self, series: str, experiment: str):
        cur = self.conn.execute(
            "SELECT item FROM results WHERE series=? AND experiment=?",
            (series, experiment),
        )
        return [r[0] for r in cur.fetchall()]

    def close(self) -> None:
        self.conn.close()


def run_pointing_benchmark(
    saliency_fn: Callable[[np.ndarray, int], np.ndarray],
    dataset: Iterable[Tuple[np.ndarray, int, np.ndarray]],
    num_classes: int,
    *,
    tolerance: int = 15,
    store: Optional[ExperimentStore] = None,
    series: str = "default",
    experiment: str = "pointing",
) -> PointingGame:
    """Evaluate a saliency method with the pointing game.

    dataset yields (image (H,W,C) uint8/float, class_id, gt_mask {0,1} (H,W)).
    saliency_fn(image, class_id) -> (h, w) map, an array or a tensor on any
    device (resized there, as ``jax.image.resize`` does, if its shape is not
    the mask's).
    """
    game = PointingGame(num_classes, tolerance=tolerance)
    for idx, (image, class_id, mask) in enumerate(dataset):
        sal = torch.as_tensor(saliency_fn(image, class_id))
        if sal.dim() != 2:
            raise ValueError(
                f"saliency_fn must return a 2-D (h, w) map, got {tuple(sal.shape)}: "
                "per-class methods should be indexed before returning")
        if tuple(sal.shape) != mask.shape:
            sal = resize_bilinear(sal.to(torch.float32), mask.shape)
        sal = sal.detach().cpu().numpy()
        point = saliency_point(sal)
        hit = game.evaluate(mask.astype(bool), point)
        game.aggregate(hit, class_id)
        if store is not None:
            store.save(series, experiment, str(idx), {
                "class": int(class_id), "point": list(point), "hit": int(hit),
            })
    return game
