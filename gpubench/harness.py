"""What every run shares: the cell's files, the seeded inputs, the program's
config, and the run's outcome.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``:
the model's sizes, its dtype and recipe) and a traffic mix
(``traffic/<name>.json``: the loop that drives the program and its
parameters); ``cells/<cell>.json`` adds what is fixed for that cell alone
(a rate, the comparison's limits) over the traffic's parameters. The
traffic's ``loop`` names the module under ``loops/`` that runs it.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
from typing import Any, Dict, Optional

import numpy as np

ROOT = os.path.normpath(os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
HERE = os.path.join(ROOT, "gpubench")

__all__ = ["Ctx", "Outcome", "ROOT", "load_ctx", "load_json", "port_config", "quiesce",
           "seeded_images", "seeded_labels"]


def load_json(*parts: str) -> Dict[str, Any]:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


@dataclasses.dataclass
class Ctx:
    """One run of one cell."""

    name: str
    config: Dict[str, Any]
    params: Dict[str, Any]
    seed: int
    seconds: float
    trace: bool
    device: Any  # torch.device
    t_start: float  # time.perf_counter() at the process's start
    peaks: Optional[Dict[str, float]] = None


@dataclasses.dataclass
class Outcome:
    """What a loop hands back: the end-to-end numbers of its window, the
    counts, the compared numbers, and what the per-layer readers read."""

    e2e: Dict[str, float]
    attempted: int
    failed: int
    numbers: Dict[str, float]
    memory_peak_bytes: int
    window_s: float
    trace: Any = None  # trace.TraceData of the traced window
    layer: Dict[str, Any] = dataclasses.field(default_factory=dict)
    answers_missing: int = 0


def load_ctx(bench: Dict, workload: str, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> Ctx:
    cell = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = load_json(ROOT, conf["file"])
    params = dict(load_json(HERE, "traffic", f"{cell['traffic']}.json"))
    cell_file = os.path.join(HERE, "cells", f"{workload}.json")
    if os.path.exists(cell_file):
        params.update(load_json(cell_file))
    return Ctx(workload, config, params, int(seed), float(seconds), bool(trace), device, t_start)


def quiesce() -> None:
    """Before a window: collect, then move every object set-up made out of
    the collector's reach (``gc.freeze``), so the window's collections scan
    only what the window makes."""
    gc.collect()
    gc.freeze()


def port_config(ctx: Ctx, batch_size: int):
    """The program's ``ScouterConfig`` for the configuration, at the seed."""
    from scouter_tpu_torch.core.config import ScouterConfig

    c = ctx.config
    return ScouterConfig(
        model=c["model"], dataset=c["dataset"], num_classes=c["num_classes"],
        channel=c["channel"], use_slot=True, slots_per_class=c["slots_per_class"],
        hidden_dim=c["hidden_dim"], power=c["power"], loss_status=c["loss_status"],
        to_k_layer=c["to_k_layer"], lambda_value=float(c["lambda_value"]),
        img_size=c["img_size"], batch_size=batch_size, lr=float(c["lr"]),
        pre_trained=False, aug=False, compute_dtype=c["compute_dtype"],
        seed=ctx.seed % 2**63, device=ctx.device.type)


def seeded_images(ctx: Ctx, n: int, stream: int) -> np.ndarray:
    """``n`` uint8 (img_size, img_size, 3) images drawn on the device, each
    with the per-image statistics photographs have: its own brightness per
    channel and contrast over smooth shapes at two scales and fine texture.
    (I.i.d. uniform noise makes every image alike in its statistics, so
    BatchNorm over pooled features, one value an image a channel, divides by
    a batch spread at the level of rounding.)"""
    import torch
    import torch.nn.functional as F

    from .weights import stream_generator

    size = ctx.config["img_size"]
    g = stream_generator(ctx.seed, stream, ctx.device)
    out = torch.empty((n, size, size, 3), dtype=torch.uint8, device=ctx.device)
    for s in range(0, n, 256):  # blocks bound the f32 working set
        m = min(256, n - s)
        coarse = F.interpolate(torch.randn(m, 3, 4, 4, generator=g, device=ctx.device),
                               size=(size, size), mode="bicubic", align_corners=False)
        mid = F.interpolate(torch.randn(m, 3, 16, 16, generator=g, device=ctx.device),
                            size=(size, size), mode="bilinear", align_corners=False)
        fine = torch.randn(m, 3, size, size, generator=g, device=ctx.device)
        look = torch.rand(m, 4, 1, 1, generator=g, device=ctx.device)
        bright = 40.0 + 175.0 * look[:, :3]
        contrast = 15.0 + 55.0 * look[:, 3:]
        x = bright + contrast * (coarse + 0.5 * mid + 0.2 * fine)
        out[s:s + m] = x.clamp_(0.0, 255.0).round_().to(torch.uint8).permute(0, 2, 3, 1)
    return out.cpu().numpy()


def seeded_labels(ctx: Ctx, n: int, stream: int) -> np.ndarray:
    import torch

    from .weights import stream_generator

    g = stream_generator(ctx.seed, stream, ctx.device)
    return torch.randint(0, ctx.config["num_classes"], (n,), generator=g,
                         device=ctx.device).cpu().numpy().astype(np.int32)
