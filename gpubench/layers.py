"""The arithmetic of the per-layer readers (``metrics/<name>.py``). Each
function takes the run's ``Reading`` and returns the metric's value, or
None where the run holds nothing to read: no trace, no such op in it, no
peak known for the card. None is never turned into 0.
"""

from __future__ import annotations

import dataclasses
import statistics
from typing import Any, Dict, Optional

from .harness import Ctx, Outcome
from .work import k1 as k1_work

__all__ = ["Reading", "batch_fill_pct", "idle_share_pct", "k1_roofline_pct", "loader_ms",
           "mfu_pct", "optimizer_ms"]

_K1_OPS = ("scouter_tpu_torch::xslot_",)
_OPTIMIZER = ("Optimizer.step#",)


@dataclasses.dataclass
class Reading:
    ctx: Ctx
    outcome: Outcome
    peaks: Optional[Dict[str, float]]
    model_flops: Any  # callable (batch, train) -> operations, from work/model_flops.py


def idle_share_pct(r: Reading) -> Optional[float]:
    t = r.outcome.trace
    if t is None or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)


def optimizer_ms(r: Reading) -> Optional[float]:
    """Device ms a step of the kernels under the optimizer's step range."""
    t = r.outcome.trace
    if t is None:
        return None
    seconds, kernels = t.device_s_under(_OPTIMIZER)
    steps = len(t.calls(_OPTIMIZER))
    return seconds * 1e3 / steps if kernels and steps else None


def loader_ms(r: Reading) -> Optional[float]:
    spans = r.outcome.layer.get("loader_s")
    return statistics.fmean(spans) * 1e3 if spans else None


def batch_fill_pct(r: Reading) -> Optional[float]:
    fill = r.outcome.layer.get("batch_fill")
    return None if fill is None else 100.0 * fill


def mfu_pct(r: Reading) -> Optional[float]:
    """The model's operations done in the window (the reference's count per
    image, forward and backward in training) over the window and the card's
    dense peak for the configuration's dtype."""
    images = r.outcome.layer.get("images")
    if r.peaks is None or not images:
        return None
    train = bool(r.outcome.layer.get("train"))
    batch = r.ctx.config["batch_size"] if train else 64
    per_image = r.model_flops(batch, train) / batch
    peak = r.peaks[r.ctx.config["compute_dtype"]]
    return 100.0 * per_image * images / r.outcome.window_s / peak


def _k1_bound_s(op, peaks) -> float:
    if op.name.endswith("xslot_bwd"):
        (b, n, d), hist = op.shapes[0], op.shapes[6]
        elem = 2 if "BFloat16" in op.dtypes[0] else 4
        return k1_work.bwd_bound_s(b, n, hist[2], d, peaks, iters=hist[1], elem=elem)
    (b, n, d), (s, _d) = op.shapes[0], op.shapes[2]
    iters = 3
    hist = iters if op.name.endswith("_hist") else 0
    return k1_work.fwd_bound_s(b, n, s, d, peaks, hist_iters=hist, iters=iters)


def k1_roofline_pct(r: Reading) -> Optional[float]:
    """K1's bound time (work/k1.py at each call's shapes) over the device
    time of the kernels its custom ops launched."""
    t = r.outcome.trace
    if t is None or r.peaks is None:
        return None
    seconds, kernels = t.device_s_under(_K1_OPS)
    if not kernels or seconds <= 0:
        return None
    bound = sum(_k1_bound_s(op, r.peaks) for op in t.calls(_K1_OPS))
    return 100.0 * bound / seconds
