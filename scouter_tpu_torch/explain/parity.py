"""Heatmap-IoU explanation-parity metrics (counterpart of
``scouter_tpu/explain/parity.py``; Pillow's resize is ``_imaging``'s
bit-exact ``resize_bilinear_u8``).

The north-star contract (BASELINE.json) requires top-1 accuracy AND
attention-map IoU parity against the reference's test.py flow. The maps being
compared are the per-class slot attention maps the reference writes from inside
the forward pass (``sloter/utils/slot_attention.py:68-85``: final-iteration
attention, per-class summed when slots_per_class > 1, min-max scaled to 0..255
over the whole per-sample map set) and then bilinear-resizes to the raw image
size (``test.py:33-38``).

These functions are numpy on the host.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from ._imaging import resize_bilinear_u8

__all__ = [
    "heatmap_iou",
    "soft_iou",
    "resize_map_bilinear",
    "iou_table",
    "format_iou_table",
]


def heatmap_iou(a: np.ndarray, b: np.ndarray, threshold: int = 128) -> float:
    """Binary IoU of two uint8 heatmaps at ``threshold`` (>= counts as on).

    Both maps follow the reference's scaling contract (min-max to 0..255), so a
    mid-scale threshold selects "the explanatory region". If neither map has any
    on-pixels the maps agree trivially -> 1.0.
    """
    a_on = np.asarray(a) >= threshold
    b_on = np.asarray(b) >= threshold
    union = np.logical_or(a_on, b_on).sum()
    if union == 0:
        return 1.0
    inter = np.logical_and(a_on, b_on).sum()
    return float(inter) / float(union)


def soft_iou(a: np.ndarray, b: np.ndarray) -> float:
    """Threshold-free IoU: sum(min)/sum(max) over the raw intensities.

    Robust companion to :func:`heatmap_iou` — insensitive to the binarization
    threshold, sensitive to any intensity-level disagreement.
    """
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    den = np.maximum(a, b).sum()
    if den == 0:
        return 1.0
    return float(np.minimum(a, b).sum() / den)


def resize_map_bilinear(m: np.ndarray, size_wh) -> np.ndarray:
    """Pillow's bilinear resize of a uint8 map, the exact test.py:33-38
    artifact; ``size_wh`` is (width, height)."""
    w, h = size_wh
    planes = torch.from_numpy(np.ascontiguousarray(np.asarray(m, np.uint8)))
    return resize_bilinear_u8(planes, int(h), int(w)).numpy()


def iou_table(
    ref_maps: Sequence[np.ndarray],
    our_maps: Sequence[np.ndarray],
    thresholds: Sequence[int] = (64, 128, 192),
) -> Dict:
    """Per-class IoU between two stacks of per-class uint8 maps.

    Returns {"per_class": [{class, iou@T..., soft_iou}], "mean": {...}}.
    """
    assert len(ref_maps) == len(our_maps), "class-count mismatch"
    rows = []
    for c, (rm, om) in enumerate(zip(ref_maps, our_maps)):
        row = {"class": c, "soft_iou": soft_iou(rm, om)}
        for t in thresholds:
            row[f"iou@{t}"] = heatmap_iou(rm, om, t)
        rows.append(row)
    mean = {
        k: float(np.mean([r[k] for r in rows]))
        for k in rows[0]
        if k != "class"
    }
    return {"per_class": rows, "mean": mean}


def format_iou_table(report: Dict) -> str:
    """Render an iou_table() dict as a markdown table."""
    keys = [k for k in report["per_class"][0] if k != "class"]
    lines = ["| class | " + " | ".join(keys) + " |",
             "|---" * (len(keys) + 1) + "|"]
    for r in report["per_class"]:
        lines.append(
            "| " + str(r["class"]) + " | "
            + " | ".join(f"{r[k]:.4f}" for k in keys) + " |"
        )
    lines.append(
        "| **mean** | "
        + " | ".join(f"{report['mean'][k]:.4f}" for k in keys) + " |"
    )
    return "\n".join(lines)
