"""The xSlot attention iteration (counterpart of ``scouter_tpu/ops/slot_attention.py``).

Numeric contract (reference ``sloter/utils/slot_attention.py:44-96``):

- ``num_slots = num_classes * slots_per_class``; learned initial slots (1, S, d)
  broadcast over the batch
- keys ``k = to_k(inputs_pe)``, a stack of ``to_k_layer`` Linear layers with
  ReLU between; values are the features without position embedding
- ``to_q`` is bypassed in the reference (``q = slots``), so it is not created
- per iteration (3 fixed iterations):
    dots  = (slots @ k^T) * d**-0.5
    dots  = dots / dots.sum(j) * dots.sum(i, j)   (no epsilon, by design)
    attn  = sigmoid(dots)
    upd   = (attn @ inputs_x) / d
    slots = GRUCell(upd, slots)
- after the loop the *updates* are sum-pooled per class when
  slots_per_class > 1; the class scores are ``loss_status * updates.sum(-1)``
  and the area loss is ``(sum(attn) / (B*S*N)) ** power``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from .gru import GRUParams, gru_cell, init_gru_params

__all__ = ["XSlotConfig", "class_attention_maps", "init_xslot_params", "xslot_attention",
           "xslot_iteration"]


@dataclasses.dataclass(frozen=True)
class XSlotConfig:
    """Static configuration of the xSlot module."""

    num_classes: int
    slots_per_class: int = 1
    dim: int = 64
    iters: int = 3
    loss_status: float = 1.0
    power: float = 1.0
    to_k_layer: int = 1

    @property
    def num_slots(self) -> int:
        return self.num_classes * self.slots_per_class


def init_xslot_params(generator: torch.Generator, cfg: XSlotConfig,
                      dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """xSlot parameters with the reference's init distributions
    (``sloter/utils/slot_attention.py:20-38``): initial slots ~ N(mu,
    |sigma|) with mu and sigma standard-normal per feature (shared by the
    slots), the to_k Linear layers and the GRU at torch's default
    U(-1/sqrt(d), 1/sqrt(d)). Drawn from ``generator`` in the order mu,
    sigma, the slots, each to_k layer's weight and bias, the GRU."""
    g, d = generator, cfg.dim
    mu = torch.empty(1, 1, d, dtype=dtype).normal_(generator=g)
    sigma = torch.empty(1, 1, d, dtype=dtype).normal_(generator=g)
    draw = torch.empty(1, cfg.num_slots, d, dtype=dtype).normal_(generator=g)
    bound = 1.0 / d ** 0.5
    to_k: List[Dict[str, torch.Tensor]] = []
    for _ in range(cfg.to_k_layer):
        # torch Linear layout (out, in)
        to_k.append({"weight": torch.empty(d, d, dtype=dtype).uniform_(-bound, bound, generator=g),
                     "bias": torch.empty(d, dtype=dtype).uniform_(-bound, bound, generator=g)})
    return {"initial_slots": mu + sigma.abs() * draw, "to_k": to_k,
            "gru": init_gru_params(g, d, dtype)}


def _apply_to_k(to_k: Sequence[Dict[str, torch.Tensor]], x: torch.Tensor) -> torch.Tensor:
    """Linear(+ReLU+Linear)*: ReLU between layers, none after the last."""
    for i, layer in enumerate(to_k):
        if i > 0:
            x = torch.relu(x)
        x = x @ layer["weight"].T + layer["bias"]
    return x


def xslot_iteration(
    slots: torch.Tensor,
    k: torch.Tensor,
    values: torch.Tensor,
    gru: GRUParams,
    scale: float,
    div: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One xSlot iteration. Returns (new_slots, updates, attn).

    slots: (B, S, d), k/values: (B, N, d). ``div``: the updates' divisor
    where it is not d (the true width of zero-padded inputs).
    """
    b, s, d = slots.shape
    dots = torch.einsum("bid,bjd->bij", slots, k) * scale  # (B, S, N)
    row_sum = dots.sum(dim=2, keepdim=True)
    total = dots.sum(dim=(1, 2), keepdim=True)
    dots = dots / row_sum * total
    attn = torch.sigmoid(dots)
    updates = torch.einsum("bij,bjd->bid", attn, values) / (d if div is None else div)
    new_slots = gru_cell(gru, updates.reshape(b * s, d), slots.reshape(b * s, d))
    return new_slots.reshape(b, s, d), updates, attn


def xslot_attention(
    params: Dict,
    cfg: XSlotConfig,
    inputs_pe: torch.Tensor,
    inputs_x: torch.Tensor,
    *,
    fused: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full xSlot module forward.

    Args:
      params: ``{"initial_slots": (1, S, d), "to_k": [{"weight", "bias"}, ...],
        "gru": GRUParams}``.
      inputs_pe: (B, N, d) position-embedded features, the key source.
      inputs_x: (B, N, d) raw features, the value source.
      fused: run the iteration loop through ``slot_kernel.xslot_iterations_fused``
        (the CUDA kernel on the card, its plain version on the CPU).

    Returns:
      (class_logits (B, C), area_loss scalar, attn (B, S, N)).
    """
    b, n, d = inputs_pe.shape
    scale = float(d) ** -0.5
    k = _apply_to_k(params["to_k"], inputs_pe)

    if fused:
        from .slot_kernel import xslot_iterations_fused

        gru = params["gru"]
        updates, attn = xslot_iterations_fused(
            k.contiguous(), inputs_x.contiguous(), params["initial_slots"][0],
            gru["w_ih"], gru["w_hh"], gru["b_ih"][None], gru["b_hh"][None],
            cfg.iters,
        )
    else:
        slots = params["initial_slots"].expand(b, cfg.num_slots, d)
        updates = attn = None
        for _ in range(cfg.iters):
            slots, updates, attn = xslot_iteration(slots, k, inputs_x, params["gru"], scale)

    if cfg.slots_per_class > 1:
        pooled = updates.reshape(b, cfg.num_classes, cfg.slots_per_class, d).sum(dim=2)
    else:
        pooled = updates

    area = attn.sum() / (attn.shape[0] * attn.shape[1] * attn.shape[2])
    area = torch.pow(area, cfg.power)
    logits = cfg.loss_status * pooled.sum(dim=-1)  # (B, C)
    return logits, area, attn


def class_attention_maps(attn: torch.Tensor, num_classes: int, slots_per_class: int) -> torch.Tensor:
    """Collapse per-slot attention to per-class maps: (B, S, N) -> (B, C, N)."""
    if slots_per_class == 1:
        return attn
    b, s, n = attn.shape
    return attn.reshape(b, num_classes, slots_per_class, n).sum(dim=2)
