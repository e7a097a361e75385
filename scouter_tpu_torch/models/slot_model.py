"""SCOUTER SlotModel: backbone -> conv1x1 -> + sine PE -> xSlot -> class scores
(counterpart of ``scouter_tpu/models/slot_model.py``).

- 1x1 conv (with bias) to hidden_dim + ReLU on the backbone's feature map
- the sine position embedding is added for the keys only; values see none
- the map flattens to (B, N, hidden) row-major over (y, x)
- xSlot attention returns class scores, the area loss and the final attention

The module returns raw class scores with the area loss and attention beside
them; the loss is not composed inside ``forward``. In no-slot mode the model
is the backbone with its own classifier.

The head's parameters are f32 master copies. With a ``head_dtype`` (a bf16
slot head, ``--slot_head_dtype compute``) the 1x1 conv and the xSlot module
cast them and their inputs to it at use, as
``scouter_tpu/models/slot_model.py:97-105`` does.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ..ops.position import sine_position_embedding
from ..ops.slot_attention import XSlotConfig, xslot_attention
from .layers import Conv2d

__all__ = ["SlotModel", "SlotModelOutput", "XSlot"]

# what SlotModel.forward returns: logits, and in slot mode area_loss and attn
SlotModelOutput = Dict[str, torch.Tensor]


class _GRUWeights(nn.Module):
    """The parameters of a one-layer ``nn.GRU(d, d)`` under its names
    (``weight_ih_l0`` ...); the cell itself is ``ops.gru.gru_cell``."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight_ih_l0 = nn.Parameter(torch.empty(3 * dim, dim))
        self.weight_hh_l0 = nn.Parameter(torch.empty(3 * dim, dim))
        self.bias_ih_l0 = nn.Parameter(torch.empty(3 * dim))
        self.bias_hh_l0 = nn.Parameter(torch.empty(3 * dim))


class XSlot(nn.Module):
    """xSlot parameters under the reference's names (``initial_slots``,
    ``to_k.0/2/4``, ``gru.*_l0``) around the functional core. With a
    ``compute_dtype`` the parameters and the inputs are cast to it at use;
    otherwise the inputs are cast to the parameters' dtype."""

    def __init__(self, num_classes: int, slots_per_class: int = 1, dim: int = 64,
                 iters: int = 3, loss_status: float = 1.0, power: float = 1.0,
                 to_k_layer: int = 1, fused: bool = False, compute_dtype=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.cfg = XSlotConfig(num_classes=num_classes, slots_per_class=slots_per_class,
                               dim=dim, iters=iters, loss_status=loss_status, power=power,
                               to_k_layer=to_k_layer)
        self.fused = fused
        self.initial_slots = nn.Parameter(torch.empty(1, self.cfg.num_slots, dim))
        layers = []
        for i in range(to_k_layer):
            if i > 0:
                layers.append(nn.ReLU())
            layers.append(nn.Linear(dim, dim))
        self.to_k = nn.Sequential(*layers)  # Linear at Sequential indices 0, 2, 4, ...
        self.gru = _GRUWeights(dim)

    def forward(self, inputs_pe: torch.Tensor, inputs_x: torch.Tensor):
        dt = self.compute_dtype or self.initial_slots.dtype
        params = {
            "initial_slots": self.initial_slots.to(dt),
            "to_k": [{"weight": m.weight.to(dt), "bias": m.bias.to(dt)}
                     for m in self.to_k if isinstance(m, nn.Linear)],
            "gru": {"w_ih": self.gru.weight_ih_l0.to(dt), "w_hh": self.gru.weight_hh_l0.to(dt),
                    "b_ih": self.gru.bias_ih_l0.to(dt), "b_hh": self.gru.bias_hh_l0.to(dt)},
        }
        return xslot_attention(params, self.cfg, inputs_pe.to(dt), inputs_x.to(dt),
                               fused=self.fused)


class SlotModel(nn.Module):
    """Full SCOUTER model over any registered backbone.

    ``forward`` takes a (B, C, H, W) float batch in the backbone's dtype and
    returns ``logits`` (B, num_classes) and, in slot mode, ``area_loss`` and
    ``attn`` (B, S, N). The slot head (conv1x1 + xSlot) computes in
    ``head_dtype`` over its f32 parameters, cast at use (a bf16 slot head),
    or, with none, in the dtype of its parameters: f32 under a bf16
    backbone unless asked otherwise (``build_slot_model``).
    """

    def __init__(self, backbone: nn.Module, use_slot: bool = True, num_classes: int = 10,
                 hidden_dim: int = 64, slots_per_class: int = 1, loss_status: float = 1.0,
                 power: float = 1.0, to_k_layer: int = 1, lambda_value: float = 1.0,
                 iters: int = 3, fused_slot: bool = False, head_dtype=None):
        super().__init__()
        self.backbone = backbone
        self.use_slot = use_slot
        self.hidden_dim = hidden_dim
        self.lambda_value = lambda_value
        self.head_dtype = head_dtype
        if use_slot:
            self.conv1x1 = Conv2d(backbone.num_features, hidden_dim, 1, bias=True,
                                  compute_dtype=head_dtype)
            self.slot = XSlot(num_classes=num_classes, slots_per_class=slots_per_class,
                              dim=hidden_dim, iters=iters, loss_status=loss_status,
                              power=power, to_k_layer=to_k_layer, fused=fused_slot,
                              compute_dtype=head_dtype)

    def forward(self, x: torch.Tensor) -> SlotModelOutput:
        if not self.use_slot:
            return {"logits": self.backbone(x)}
        feats = self.backbone(x, features_only=True)  # (B, C, h, w)
        feats = feats.to(self.head_dtype or self.conv1x1.weight.dtype)
        feats = torch.relu(self.conv1x1(feats))
        b, _, fh, fw = feats.shape
        feats = feats.permute(0, 2, 3, 1)  # (B, h, w, hidden)
        pe = sine_position_embedding(fh, fw, self.hidden_dim, dtype=feats.dtype,
                                     device=feats.device)
        inputs_x = feats.reshape(b, fh * fw, self.hidden_dim)
        inputs_pe = (feats + pe).reshape(b, fh * fw, self.hidden_dim)
        logits, area, attn = self.slot(inputs_pe, inputs_x)
        return {"logits": logits, "area_loss": area, "attn": attn}
