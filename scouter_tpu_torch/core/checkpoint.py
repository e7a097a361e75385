"""Checkpoint I/O with the reference's naming and cadence (counterpart of
``scouter_tpu/core/checkpoint.py``).

One 'latest' checkpoint per config name, overwritten each epoch, plus an
archive copy when ``(epoch+1) % lr_drop == 0`` or ``(epoch+1) % 10 == 0``
(``train.py:181-196``). The name encodes dataset, slot mode, loss sign and
area-size setting (``config.checkpoint_name``) and is re-derived by the test
CLI, so it is a de-facto API; the extension is the reference's ``.pth``.

Contents: a ``torch.save`` dict of ``model`` (state dict), ``optimizer``
(state dict), ``epoch``, ``step`` and ``config`` (the dataclass as a dict);
a mid-epoch preemption checkpoint adds ``batch`` (the train batches of
``epoch`` done) and ``metric_sums`` (that epoch's running sums), keys that an
epoch-end checkpoint lacks. Parameters, BN statistics and AdamW state are
f32 whatever ``--compute_dtype`` trained them, and are saved from host
copies, so a checkpoint restores to any build and device.

Writes go through ``path + ".tmp"`` and ``os.replace``. With an
:class:`AsyncCheckpointWriter` the host copy of the state is still taken on
the caller's thread, before the next step changes the parameters in place;
serialising and writing run on the writer's thread.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import queue
import threading
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from .config import ScouterConfig, checkpoint_name

__all__ = ["AsyncCheckpointWriter", "checkpoint_path", "restore_checkpoint",
           "save_checkpoint", "save_on_master"]


def checkpoint_path(output_dir: str, cfg: ScouterConfig, epoch: Optional[int] = None) -> str:
    return os.path.join(output_dir, checkpoint_name(cfg, epoch) + ".pth")


def save_on_master(payload: Dict[str, Any], path: str) -> None:
    """``torch.save`` ``payload`` to ``path + ".tmp"``, then ``os.replace``
    it to ``path`` (the reference's ``save_on_master``; the port runs one
    process, which is the master)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


class AsyncCheckpointWriter:
    """One daemon thread that runs submitted writes in order (FIFO). The
    first error is re-raised at :meth:`drain`; the Trainer drains at the end
    of ``fit`` and before a preemption exit, so no failed write passes
    silently. :meth:`close` drains and joins."""

    def __init__(self):
        self._q: "queue.Queue" = queue.Queue()
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, name="checkpoint-writer",
                                        daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while True:
            fn = self._q.get()
            try:
                if fn is None:
                    return
                fn()
            except BaseException as exc:  # kept for drain(), which re-raises it
                if self._err is None:
                    self._err = exc
            finally:
                self._q.task_done()

    def submit(self, fn: Callable[[], None]) -> None:
        self._q.put(fn)

    def drain(self) -> None:
        """Wait for every submitted write; re-raise the first error."""
        self._q.join()
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def close(self) -> None:
        try:
            self.drain()
        finally:  # stop the thread even when drain re-raises
            self._q.put(None)
            self._thread.join(timeout=10.0)


def _to_host(tree):
    """A copy of every tensor of a state dict tree on the CPU."""
    if torch.is_tensor(tree):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def save_checkpoint(output_dir: str, cfg: ScouterConfig, state, epoch: int,
                    batch: Optional[int] = None, metric_sums: Optional[Dict[str, Any]] = None,
                    writer: Optional[AsyncCheckpointWriter] = None) -> Tuple[str, ...]:
    """Save the latest checkpoint, plus the archive copy on the reference's
    cadence. ``state`` is a ``train.state.TrainState``. Returns the paths.

    ``batch``: the train batches of ``epoch`` done, for a mid-epoch
    preemption checkpoint, which overwrites only the latest path.
    ``metric_sums``: ``{"sums": {name: float}, "n": int}``, the interrupted
    epoch's running sums, so that the resumed epoch logs the average over all
    its batches. ``writer``: serialise and write on its thread."""
    paths = [checkpoint_path(output_dir, cfg)]
    if batch is None and ((epoch + 1) % cfg.lr_drop == 0 or (epoch + 1) % 10 == 0):
        paths.append(checkpoint_path(output_dir, cfg, epoch))
    payload = {
        "model": _to_host(state.model.state_dict()),
        "optimizer": _to_host(state.optimizer.state_dict()),
        "epoch": int(epoch),
        "step": int(state.step),
        "config": dataclasses.asdict(cfg),
    }
    if batch is not None:
        payload["batch"] = int(batch)
    if metric_sums is not None:
        payload["metric_sums"] = {
            "sums": {k: float(v) for k, v in metric_sums["sums"].items()},
            "n": int(metric_sums["n"])}

    def serialise_and_write():
        for path in paths:
            save_on_master(payload, path)

    if writer is not None:
        writer.submit(serialise_and_write)
    else:
        serialise_and_write()
    return tuple(paths)


def restore_checkpoint(path: str, state, *, optimizer: bool = True, return_batch: bool = False,
                       return_extras: bool = False) -> Tuple[Any, ...]:
    """Load a checkpoint into ``state`` (model and, with ``optimizer``, the
    optimizer, in place, on the model's device). Returns (state, epoch,
    config dict); ``return_batch`` appends the preemption cursor (None at an
    epoch end), ``return_extras`` a dict of the optional entries
    (``metric_sums``).

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
    out = (state, int(payload.get("epoch", -1)), payload.get("config"))
    if return_batch:
        batch = payload.get("batch")
        out += (None if batch is None else int(batch),)
    if return_extras:
        out += ({k: payload[k] for k in ("metric_sums",) if k in payload},)
    return out
