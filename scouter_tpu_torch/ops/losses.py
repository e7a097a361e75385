"""SCOUTER loss composition (counterpart of ``scouter_tpu/ops/losses.py``).

Reference contract (``sloter/slot_model.py:117-125``):
    output = log_softmax(logits, axis=1)
    loss   = nll_loss(output, target) + lambda_value * area_loss   (slot mode)
    loss   = nll_loss(output, target)                              (no-slot mode)

``nll_loss`` with log-probabilities is mean cross-entropy over the batch.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["log_softmax_nll", "scouter_loss"]


def log_softmax_nll(logits: torch.Tensor, labels: torch.Tensor):
    """Return (log_probs, mean NLL). labels: int (B,).

    The logits are upcast to float32 first, so a bf16 backbone's class scores
    reduce in f32."""
    log_probs = torch.log_softmax(logits.to(torch.float32), dim=1)
    nll = -log_probs.gather(1, labels.long()[:, None]).mean()
    return log_probs, nll


def scouter_loss(logits: torch.Tensor, labels: torch.Tensor,
                 area_loss: Optional[torch.Tensor] = None, lambda_value: float = 1.0):
    """Compose the SCOUTER training loss.

    Returns (log_probs, loss_dict) where loss_dict mirrors the reference's
    ``[loss, nll, att_loss]`` list (``slot_model.py:121-122``).
    """
    log_probs, nll = log_softmax_nll(logits, labels)
    if area_loss is None:
        return log_probs, {"loss": nll}
    area_loss = area_loss.to(torch.float32)
    total = nll + lambda_value * area_loss
    return log_probs, {"loss": total, "log_loss": nll, "att_loss": area_loss}
