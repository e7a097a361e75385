"""Graceful preemption for long training runs (counterpart of
``scouter_tpu/train/preempt.py``).

Cluster schedulers send SIGTERM with a grace window before they kill a
worker. The reference resumes only at epoch boundaries
(``train.py:163-169``), so a preempted run loses its epoch. The Loader is
deterministic per (seed, epoch, batch index) (``data/pipeline.py``), so a
mid-epoch checkpoint that records the completed batches resumes exactly:
skip that prefix, go on, and the final parameters equal an uninterrupted
run's bit for bit (``tests/test_torch_resilience.py``).

With ``--preempt_save true`` the Trainer installs a :class:`PreemptionGuard`;
on SIGTERM the current train step finishes, a checkpoint with the batch
cursor is written synchronously, and ``fit`` returns. ``--resume true``
picks the cursor up.
"""

from __future__ import annotations

import signal
import threading
import warnings
from typing import Sequence

__all__ = ["PreemptionGuard"]


class PreemptionGuard:
    """Turns termination signals into a flag that the training loop polls
    after every completed train step.

    The handler sets an event and prints one line: no CUDA calls and no
    checkpoint I/O. A second signal while the flag is set goes to the
    previous handler (by default the signal's own action, termination), so a
    scheduler that loses patience can still kill the process."""

    def __init__(self, signals: Sequence[int] = (signal.SIGTERM,)):
        self._signals = tuple(signals)
        self._event = threading.Event()
        self._prev: dict = {}
        self._installed = False

    def install(self) -> "PreemptionGuard":
        """Install the handlers. Only the main thread may; elsewhere this
        warns and the run goes unguarded."""
        try:
            for sig in self._signals:
                self._prev[sig] = signal.signal(sig, self._handle)
            self._installed = True
        except ValueError:
            warnings.warn("PreemptionGuard: not on the main thread; signals will not be "
                          "caught", RuntimeWarning)
        return self

    def uninstall(self) -> None:
        if not self._installed:
            return
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._prev.clear()
        self._installed = False

    def _handle(self, signum, frame) -> None:
        if self._event.is_set():
            prev = self._prev.get(signum)
            if callable(prev):
                prev(signum, frame)
            elif prev == signal.SIG_DFL:
                signal.signal(signum, signal.SIG_DFL)
                signal.raise_signal(signum)
            return
        self._event.set()
        print(f"[preempt] caught signal {signum}: will checkpoint after the current step "
              "and exit")

    def trigger(self) -> None:
        """Set the flag without a signal (tests, external schedulers)."""
        self._event.set()

    @property
    def triggered(self) -> bool:
        return self._event.is_set()
