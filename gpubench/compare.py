"""The numbers that decide ``correct``, each held to the limit the cell's file
gives it.

Training (the first three steps of the timed path against the reference's):

- ``loss1_gap``: the first step's |program loss - reference loss| /
  |reference loss|;
- ``grad_gap``: the worst leaf's |program norm - reference norm| of the
  first gradient, over the larger of that leaf's reference norm and the
  median leaf's;
- ``change_median_gap``: the median leaf's gap, taken the same way, of the
  norm of each leaf's change over the three steps, over the leaves whose
  first reference gradient reaches a thousandth of the median leaf's (a
  leaf whose gradient is nought to rounding, such as a bias before a
  BatchNorm, moves under AdamW by round-off alone).

A cell's ``limits`` name the numbers it compares (PERF.md gives why each
was chosen and the readings each limit was set from).

Serving (a sample of the answers against the reference's on the same
images):

- ``logits_gap``: the worst sampled answer's largest |program logit -
  reference logit| over the largest |reference logit| of that answer;
- ``maps_gap``: the mean |program level - reference level| over every pixel
  of the sampled slot maps;
- an answer that never came, or came as an error, fails the run.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Mapping, Sequence

import numpy as np

__all__ = ["GRAD_FLOOR", "held", "serve_numbers", "train_numbers"]

GRAD_FLOOR = 1e-3


def _rel(a: float, b: float, scale: float) -> float:
    """|a - b| / scale, infinite where either side is not a finite number
    (a NaN would otherwise drop out of a max)."""
    d = abs(a - b) / max(scale, 1e-30)
    return d if math.isfinite(d) else math.inf


def _leaf_gaps(prog: Mapping[str, float], ref: Mapping[str, float],
               names: Sequence[str]) -> List[float]:
    median = statistics.median(ref[n] for n in names)
    return [_rel(prog[n], ref[n], max(ref[n], median)) for n in names]


def train_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """``prog`` and ``ref``: {"losses": [3], "grad": {leaf: norm}, "change":
    {leaf: norm}}."""
    if len(prog["losses"]) != len(ref["losses"]) or set(prog["grad"]) != set(ref["grad"]):
        raise ValueError("the program's and the reference's readings cover different steps or "
                         "leaves")
    names = sorted(ref["grad"])
    median = statistics.median(ref["grad"][n] for n in names)
    moving = [n for n in names if ref["grad"][n] >= GRAD_FLOOR * median]
    grad = _leaf_gaps(prog["grad"], ref["grad"], names)
    change = _leaf_gaps(prog["change"], ref["change"], moving)
    return {"loss1_gap": _rel(prog["losses"][0], ref["losses"][0], abs(ref["losses"][0])),
            "grad_gap": max(grad), "change_median_gap": _median(change)}


def _median(values: Sequence[float]) -> float:
    """The median, infinite where a value is not a finite number."""
    return statistics.median(values) if all(math.isfinite(v) for v in values) else math.inf


def serve_numbers(prog: List[Dict[str, np.ndarray]], ref: List[Dict[str, np.ndarray]]
                  ) -> Dict[str, float]:
    """``prog`` and ``ref``: one dict of ``logits`` (C,) and ``slot_maps``
    (C, side, side) uint8 per sampled answer, in one order."""
    worst, level_sum, pixels = 0.0, 0.0, 0
    for p, r in zip(prog, ref):
        d = float(np.abs(p["logits"].astype(np.float64) - r["logits"].astype(np.float64)).max())
        worst = max(worst, _rel(d, 0.0, float(np.abs(r["logits"]).max())))
        diff = np.abs(p["slot_maps"].astype(np.int32) - r["slot_maps"].astype(np.int32))
        level_sum += float(diff.sum())
        pixels += diff.size
    return {"logits_gap": worst, "maps_gap": level_sum / max(pixels, 1)}


def held(numbers: Mapping[str, float], limits: Mapping[str, float]) -> Dict[str, Dict]:
    """Each number the cell's limits name, beside its limit; a limit whose
    number the run did not produce fails."""
    return {k: {"value": numbers.get(k, math.inf), "limit": lim,
                "ok": numbers.get(k, math.inf) <= lim} for k, lim in limits.items()}
