"""LR schedule factory (counterpart of ``scouter_tpu/train/scheduler_factory.py``,
timm's ``create_scheduler``, ``timm/scheduler/scheduler_factory.py:7``).

Pure Python, the JAX package's arithmetic line for line, so both give the
same floats. Every schedule is an epoch-indexed callable ``epoch -> lr``;
``train/steps.py::set_learning_rate`` writes the value into the optimizer.

Schedule math mirrors the reference ``_get_lr`` implementations: step
(``step_lr.py:40-45``), cosine with cycles/decay (``cosine_lr.py:62-89``),
tanh (``tanh_lr.py:66-96``), linear warmup (lr(t) = init + t*(target-init)/
warmup_t, reaching the target at the first post-warmup epoch; the tanh
warmup targets the tanh value at warmup_t, ``tanh_lr.py:59-63``), and seeded
noise (``scheduler.py:87-105``: ``np.random.RandomState(noise_seed + t)``).
``multistep`` is an extra convenience not present in the reference.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import numpy as np

__all__ = ["create_scheduler", "PlateauScheduler"]

Schedule = Callable[[int], float]


def _cycle(t: int, t_initial: int, t_mul: float):
    """(cycle index, cycle length, position in cycle) — cosine_lr.py:69-76."""
    if t_mul != 1.0:
        i = math.floor(math.log(1 - t / t_initial * (1 - t_mul), t_mul))
        t_i = t_mul**i * t_initial
        t_curr = t - (1 - t_mul**i) / (1 - t_mul) * t_initial
    else:
        i = t // t_initial
        t_i = t_initial
        t_curr = t - t_initial * i
    return i, t_i, t_curr


def _add_noise(lr: float, t: int, noise_range, noise_pct: float,
               noise_std: float, noise_seed: int, noise_type: str) -> float:
    """Seeded per-epoch lr noise (scheduler.py:87-105): normal (resampled into
    the pct bound) or uniform, multiplicative (lr + lr*noise)."""
    if noise_range is None:
        return lr
    if isinstance(noise_range, (list, tuple)):
        apply = noise_range[0] <= t < noise_range[1]
    else:
        apply = t >= noise_range
    if not apply:
        return lr
    rng = np.random.RandomState(noise_seed + t)
    if noise_type == "normal":
        while True:
            noise = float(rng.randn()) * noise_std
            if abs(noise) < noise_pct:
                break
    else:
        noise = 2 * (float(rng.rand()) - 0.5) * noise_pct
    return lr + lr * noise


def create_scheduler(
    sched: str,
    base_lr: float,
    epochs: int,
    *,
    decay_epochs: int = 30,
    decay_rate: float = 0.1,
    decay_milestones: Optional[Sequence[int]] = None,
    min_lr: float = 1e-5,
    warmup_epochs: int = 0,
    warmup_lr_init: float = 1e-6,
    cycle_limit: int = 1,
    cycle_mul: float = 1.0,
    noise_range=None,
    noise_pct: float = 0.67,
    noise_std: float = 1.0,
    noise_seed: int = 42,
    noise_type: str = "normal",
) -> Schedule:
    sched = sched.lower()
    t_initial = max(epochs, 1)

    if sched == "step":
        def base(t):
            return base_lr * (decay_rate ** (t // decay_epochs))

        warmup_target = base_lr
    elif sched == "multistep":
        milestones = sorted(decay_milestones or [])

        def base(t):
            k = sum(1 for m in milestones if t >= m)
            return base_lr * (decay_rate**k)

        warmup_target = base_lr
    elif sched == "cosine":
        def base(t):
            i, t_i, t_curr = _cycle(t, t_initial, cycle_mul)
            if cycle_limit == 0 or i < cycle_limit:
                gamma = decay_rate**i
                lo = min_lr * gamma
                hi = base_lr * gamma
                return lo + 0.5 * (hi - lo) * (1 + math.cos(math.pi * t_curr / t_i))
            return min_lr

        warmup_target = base_lr
    elif sched == "tanh":
        lb, ub = -6.0, 4.0

        def base(t):
            i, t_i, t_curr = _cycle(t, t_initial, cycle_mul)
            if cycle_limit == 0 or i < cycle_limit:
                gamma = decay_rate**i
                lo = min_lr * gamma
                hi = base_lr * gamma
                tr = t_curr / t_i
                return lo + 0.5 * (hi - lo) * (1 - math.tanh(lb * (1.0 - tr) + ub * tr))
            return min_lr

        # tanh warmup ramps to the tanh value AT warmup_t (tanh_lr.py:59-63)
        warmup_target = base(warmup_epochs) if warmup_epochs else base_lr
    else:
        raise ValueError(f"unknown scheduler {sched!r} (plateau uses PlateauScheduler)")

    def fn(t: int) -> float:
        if warmup_epochs and t < warmup_epochs:
            lr = warmup_lr_init + t * (warmup_target - warmup_lr_init) / warmup_epochs
        else:
            lr = base(t)
        return _add_noise(lr, t, noise_range, noise_pct, noise_std,
                          noise_seed, noise_type)

    return fn


class PlateauScheduler:
    """ReduceLROnPlateau semantics: decay when the metric stops improving."""

    def __init__(self, base_lr: float, *, decay_rate: float = 0.1, patience: int = 10,
                 min_lr: float = 1e-6, mode: str = "max", threshold: float = 1e-4):
        self.lr = base_lr
        self.decay_rate = decay_rate
        self.patience = patience
        self.min_lr = min_lr
        self.mode = mode
        self.threshold = threshold
        self.best: Optional[float] = None
        self.bad_epochs = 0

    def step(self, metric: float) -> float:
        improved = (
            self.best is None
            or (self.mode == "max" and metric > self.best + self.threshold)
            or (self.mode == "min" and metric < self.best - self.threshold)
        )
        if improved:
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.lr = max(self.lr * self.decay_rate, self.min_lr)
                self.bad_epochs = 0
        return self.lr
