"""The model's weights from the seed, made on the device in a few large calls.

One normal and one uniform draw from a ``torch.Generator`` on ``device``
cover every random entry of ``reference.model.param_spec``; each entry is a
slice of them, scaled: fan-out or fan-in normals cut at two standard
deviations (the port's truncated-normal inits, their spread matched), the
xSlot Linear and GRU weights uniform in +-1/sqrt(d), the initial slots
N(mu, |sigma|) with standard-normal mu and sigma per feature, BatchNorm at
unit scale and zero shift with fresh running statistics. All f32, the dtype
the program keeps its parameters in. The same seed gives the same weights,
which the program loads and the reference reads.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from .reference.model import Spec

__all__ = ["make_weights", "stream_generator"]

# the standard deviation of N(0, 1) cut at +-2
_CUT_STD = 0.87962566103423978


def stream_generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one named stream of a seed's draws."""
    return torch.Generator(device=device).manual_seed((seed * 1_000_003 + stream) % 2**63)


def make_weights(spec: Spec, seed: int, device) -> Dict[str, torch.Tensor]:
    n_normal = n_uniform = 0
    for _name, shape, init in spec:
        numel = math.prod(shape)
        if init[0] in ("fan_out", "fan_in"):
            n_normal += numel
        elif init[0] == "slots":
            n_normal += numel + 2 * shape[-1]
        elif init[0] == "uniform":
            n_uniform += numel
    g = stream_generator(seed, 1, device)
    normal = torch.randn(n_normal, generator=g, device=device)
    uniform = torch.rand(n_uniform, generator=g, device=device)
    out: Dict[str, torch.Tensor] = {}
    i = j = 0
    for name, shape, init in spec:
        numel = math.prod(shape)
        kind = init[0]
        if kind in ("fan_out", "fan_in"):
            std = math.sqrt((2.0 if kind == "fan_out" else 1.0) / init[1]) / _CUT_STD
            out[name] = (normal[i:i + numel] * std).clamp_(-2 * std, 2 * std).view(shape)
            i += numel
        elif kind == "slots":
            d = shape[-1]
            mu, sigma = normal[i:i + d], normal[i + d:i + 2 * d]
            draw = normal[i + 2 * d:i + 2 * d + numel].view(shape)
            out[name] = mu + sigma.abs() * draw
            i += numel + 2 * d
        elif kind == "uniform":
            out[name] = ((uniform[j:j + numel] * 2.0 - 1.0) * init[1]).view(shape)
            j += numel
        elif kind == "ones":
            out[name] = torch.ones(shape, device=device)
        elif kind == "zeros":
            out[name] = torch.zeros(shape, device=device)
        elif kind == "count":
            out[name] = torch.zeros(shape, dtype=torch.int64, device=device)
        else:
            raise ValueError(f"unknown init {init!r} of {name}")
    return out
