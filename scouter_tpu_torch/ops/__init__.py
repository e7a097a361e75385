"""Slot-head operations: position embedding, GRU cell, xSlot attention, the
fused xSlot kernel, the loss and the heatmap render kernel."""

from .gru import GRUParams, gru_cell
from .losses import log_softmax_nll, scouter_loss
from .position import sine_position_embedding
from .render_kernel import jet_rgba, render_heatmaps_fused, render_heatmaps_ref
from .slot_attention import XSlotConfig, class_attention_maps, xslot_attention, xslot_iteration
from .slot_kernel import xslot_fwd_ref, xslot_iterations_fused, xslot_iterations_ref

__all__ = [
    "GRUParams",
    "XSlotConfig",
    "class_attention_maps",
    "gru_cell",
    "jet_rgba",
    "log_softmax_nll",
    "render_heatmaps_fused",
    "render_heatmaps_ref",
    "scouter_loss",
    "sine_position_embedding",
    "xslot_attention",
    "xslot_fwd_ref",
    "xslot_iteration",
    "xslot_iterations_fused",
    "xslot_iterations_ref",
]
