"""Parameter EMA (counterpart of ``scouter_tpu/utils/ema.py``, timm's
``ModelEma``, ``timm/utils.py:234-297``): after each step
``ema = decay * ema + (1 - decay) * params`` in float32.

The EMA is a dict of f32 copies of the parameters on ``device``, views of
one flat buffer, so an update is a handful of launches whatever the number
of tensors. ``decay`` stays a plain attribute that may change between
updates (timm-style warmup); each update reads it. XLA computes the update
as ``fma(decay, ema, f32((1 - decay) * params))``: the product ``decay *
ema`` unrounded; the port takes that product and the sum in float64 and
rounds once to f32, which gives XLA's bits, and the same bits on the card
as on the CPU.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..core.device import resolve_device

__all__ = ["ModelEma"]


class ModelEma:
    def __init__(self, params: Dict[str, torch.Tensor], decay: float = 0.9999, device="cuda"):
        self.decay = decay
        device = resolve_device(device)
        self._names = list(params)
        self._flat = torch.cat([params[k].detach().reshape(-1).to(device, torch.float32)
                                for k in self._names])
        views = torch.split(self._flat, [params[k].numel() for k in self._names])
        self.params = {k: v.view(params[k].shape) for k, v in zip(self._names, views)}

    @torch.no_grad()
    def update(self, params: Dict[str, torch.Tensor]) -> None:
        d = np.float32(self.decay)
        new = torch.cat([params[k].detach().reshape(-1).to(self._flat.device, torch.float32)
                         for k in self._names])
        part = new * float(np.float32(1) - d)
        self._flat.copy_(self._flat.double() * float(d) + part.double())
