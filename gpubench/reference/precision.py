"""Operand precision of the reference's products.

``EXACT`` leaves every operand as it is: the reference computes in the
dtypes the configuration states. The two lower precisions are the controls
of the comparison that decides ``correct``: the reference put in the
program's place one step below the configuration's precision.

- ``tf32``: the operands of every convolution and matrix product rounded to
  TF32 (10 stored mantissa bits, round to nearest, ties away) before an f32
  product, and the gradient that reaches the product's output rounded so in
  the backward: what a tensor core does with TF32 on, forward and backward.
- ``fp8``: the operands scaled per tensor into float8 e4m3 (forward) and
  the output's gradient into e5m2 (backward), each rounded there and scaled
  back, then the product in the dtype the configuration states: the usual
  per-tensor fp8 recipe of training and serving.

The rounding is written out in plain tensor ops so that the CPU tests and
the card compute the same control.
"""

from __future__ import annotations

import torch

__all__ = ["EXACT", "Precision", "by_name"]

_E4M3_MAX = 448.0
_E5M2_MAX = 57344.0


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    if x.dtype != torch.float32 or x.device.type == "meta":
        return x
    bits = x.contiguous().view(torch.int32)
    # add half an ulp of the 10-bit mantissa to the magnitude, then cut the
    # 13 low bits: round to nearest, ties away from zero
    rounded = (bits + 0x1000) & ~0x1FFF
    return rounded.view(torch.float32).view(x.shape)


def _round_fp8(x: torch.Tensor, fmt: torch.dtype, top: float) -> torch.Tensor:
    if x.device.type == "meta":
        return x
    xf = x.float()
    scale = xf.abs().amax().clamp_min(1e-30) / top
    return ((xf / scale).to(fmt).float() * scale).to(x.dtype)


class _Round(torch.autograd.Function):
    """Rounds the value in the forward; passes the gradient as it is."""

    @staticmethod
    def forward(ctx, x, fn):
        return fn(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _RoundGrad(torch.autograd.Function):
    """Passes the value as it is; rounds the gradient in the backward."""

    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn = fn
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g), None


class Precision:
    """How the reference's products treat their operands (module docstring)."""

    def __init__(self, name: str, operand=None, grad=None):
        self.name = name
        self._operand = operand
        self._grad = grad

    def product(self, op, *operands):
        """``op(*operands)`` with the operands rounded and the gradient of
        the result rounded, where this precision rounds."""
        if self._operand is None:
            return op(*operands)
        rounded = [_Round.apply(t, self._operand) if torch.is_tensor(t) and t.is_floating_point()
                   else t for t in operands]
        return _RoundGrad.apply(op(*rounded), self._grad)


EXACT = Precision("exact")
_TABLE = {
    "exact": EXACT,
    "tf32": Precision("tf32", _round_tf32, _round_tf32),
    "fp8": Precision("fp8", lambda t: _round_fp8(t, torch.float8_e4m3fn, _E4M3_MAX),
                     lambda t: _round_fp8(t, torch.float8_e5m2, _E5M2_MAX)),
}


def by_name(name: str) -> Precision:
    if name not in _TABLE:
        raise ValueError(f"unknown precision {name!r} (known: {sorted(_TABLE)})")
    return _TABLE[name]
