"""Slot-head operations: position embedding, GRU cell, xSlot attention and
the fused xSlot kernel."""

from .gru import GRUParams, gru_cell
from .position import sine_position_embedding
from .slot_attention import XSlotConfig, class_attention_maps, xslot_attention, xslot_iteration
from .slot_kernel import xslot_iterations_fused, xslot_iterations_ref

__all__ = [
    "GRUParams",
    "XSlotConfig",
    "class_attention_maps",
    "gru_cell",
    "sine_position_embedding",
    "xslot_attention",
    "xslot_iteration",
    "xslot_iterations_fused",
    "xslot_iterations_ref",
]
