"""Utility layer: metrics, EMA, experiment logging, profiling (counterpart
of ``scouter_tpu/utils``)."""

from .ema import ModelEma
from .metrics import evaluate_top1, evaluate_top5
from .profiling import Timer, model_cost_analysis, trace
from .saver import CheckpointSaver
from .summary import update_summary

__all__ = [
    "CheckpointSaver",
    "ModelEma",
    "Timer",
    "evaluate_top1",
    "evaluate_top5",
    "model_cost_analysis",
    "trace",
    "update_summary",
]
