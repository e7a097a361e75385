"""Checkpoint I/O with the reference's naming and cadence (counterpart of
``scouter_tpu/core/checkpoint.py``).

One 'latest' checkpoint per config name, overwritten each epoch, plus an
archive copy when ``(epoch+1) % lr_drop == 0`` or ``(epoch+1) % 10 == 0``
(``train.py:181-196``). The name encodes dataset, slot mode, loss sign and
area-size setting (``config.checkpoint_name``) and is re-derived by the test
CLI, so it is a de-facto API; the extension is the reference's ``.pth``.

Contents: a ``torch.save`` dict of ``model`` (state dict), ``optimizer``
(state dict), ``epoch``, ``step`` and ``config`` (the dataclass as a dict),
written through a temporary file and ``os.replace``. Parameters, BN
statistics and AdamW state are f32 whatever ``--compute_dtype`` trained
them, so a bf16 run's checkpoint restores to any build.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Any, Dict, Optional, Tuple

import torch

from .config import ScouterConfig, checkpoint_name

__all__ = ["checkpoint_path", "restore_checkpoint", "save_checkpoint"]


def checkpoint_path(output_dir: str, cfg: ScouterConfig, epoch: Optional[int] = None) -> str:
    return os.path.join(output_dir, checkpoint_name(cfg, epoch) + ".pth")


def save_checkpoint(output_dir: str, cfg: ScouterConfig, state, epoch: int) -> Tuple[str, ...]:
    """Save the latest checkpoint, plus the archive copy on the reference's
    cadence. ``state`` is a ``train.state.TrainState``. Returns the paths."""
    paths = [checkpoint_path(output_dir, cfg)]
    if (epoch + 1) % cfg.lr_drop == 0 or (epoch + 1) % 10 == 0:
        paths.append(checkpoint_path(output_dir, cfg, epoch))
    payload = {
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "epoch": int(epoch),
        "step": int(state.step),
        "config": dataclasses.asdict(cfg),
    }
    os.makedirs(output_dir or ".", exist_ok=True)
    for path in paths:
        tmp = path + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
    return tuple(paths)


def restore_checkpoint(path: str, state, *, optimizer: bool = True
                       ) -> Tuple[Any, int, Optional[Dict[str, Any]]]:
    """Load a checkpoint into ``state`` (model and, with ``optimizer``, the
    optimizer, in place, on the model's device). Returns (state, epoch,
    config dict).

    A checkpoint of the reference's train.py reads too: its ``args`` entry
    is an ``argparse.Namespace``, its model's ``slot.to_q.*`` entries are
    dropped (the forward bypasses to_q), and the step, epoch and config it
    lacks come back as 0, -1 and None."""
    device = next(state.model.parameters()).device
    with torch.serialization.safe_globals([argparse.Namespace]):
        payload = torch.load(path, map_location=device, weights_only=True)
    state.model.load_state_dict({k: v for k, v in payload["model"].items()
                                 if not k.startswith("slot.to_q.")})
    if optimizer:
        state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload.get("step", 0))
    return state, int(payload.get("epoch", -1)), payload.get("config")
