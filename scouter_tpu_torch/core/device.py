"""Device selection: the card unless the caller asks for the CPU."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device``; raises when CUDA is asked for and
    there is none. Never falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch sees no CUDA device; "
            "pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {device!r}")
    return dev
