"""Accuracy metrics (counterpart of ``scouter_tpu/utils/metrics.py``,
``tools/calculate_tool.py:4-16``), on the device of the logits."""

from __future__ import annotations

import torch

__all__ = ["evaluate_top1", "evaluate_top5"]


def evaluate_top1(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Fraction of samples whose argmax matches the label (a 0-d f32 tensor)."""
    return (logits.argmax(dim=1) == labels).to(torch.float32).mean()


def evaluate_top5(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Fraction of samples whose label is among the top-5 logits; ties
    broken as ``jnp.argsort`` breaks them (a stable ascending sort)."""
    k = min(5, logits.shape[1])
    top = torch.argsort(logits, dim=1, stable=True)[:, -k:]
    return (top == labels[:, None]).any(dim=1).to(torch.float32).mean()
