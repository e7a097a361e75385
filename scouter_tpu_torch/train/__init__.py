"""Training engine: state, steps, epoch loop, CLI."""

from .loop import MetricLog, Trainer, run_training
from .preempt import PreemptionGuard
from .state import (TrainState, create_train_state, make_freeze_labels,
                    restore_inference_state, step_lr)
from .steps import make_eval_step, make_train_step, set_learning_rate

__all__ = [
    "MetricLog",
    "PreemptionGuard",
    "Trainer",
    "TrainState",
    "create_train_state",
    "make_eval_step",
    "make_freeze_labels",
    "make_train_step",
    "restore_inference_state",
    "run_training",
    "set_learning_rate",
    "step_lr",
]
