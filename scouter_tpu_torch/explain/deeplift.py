"""Layer DeepLift, Rescale rule (counterpart of ``scouter_tpu/explain/deeplift.py``;
the capability the reference drives through captum, ``captum_vis.py:113-128``).

Every ReLU's backward multiplier becomes delta_out/delta_in between the
actual and the baseline activation (the local gradient where |delta_in| <
1e-7). The input and the baseline go through as one batch of two, with a
paired ReLU swapped in by ``models.act.override_relu``: the chain of
multipliers is then the gradient of ``score(x) - score(x0)``. Layer
attribution is ``(a - a0) * m`` at the stage output.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.act import override_relu

__all__ = ["layer_deeplift", "deeplift"]


class _PairedRescaleRelu(torch.autograd.Function):
    """ReLU over stacked [actual; baseline] activations (2B, ...) whose
    backward uses the DeepLift rescale multiplier (deeplift.py:25-50)."""

    @staticmethod
    def forward(ctx, z):
        ctx.save_for_backward(z)
        return torch.relu(z)

    @staticmethod
    def backward(ctx, g):
        (z,) = ctx.saved_tensors
        b = z.shape[0] // 2
        za, zb = z[:b], z[b:]
        delta = za - zb
        local = (za > 0).to(z.dtype)
        safe = torch.where(delta == 0, torch.ones_like(delta), delta)
        m = torch.where(delta.abs() > 1e-7, (torch.relu(za) - torch.relu(zb)) / safe, local)
        return torch.cat([g[:b] * m, g[b:] * m])


def _paired_rescale_relu(z: torch.Tensor) -> torch.Tensor:
    return _PairedRescaleRelu.apply(z)


def _pair_grad(fn, stacked: torch.Tensor, class_idx: int) -> torch.Tensor:
    with torch.enable_grad():
        s = stacked.detach().requires_grad_(True)
        with override_relu(_paired_rescale_relu):
            out = fn(s)
        (g,) = torch.autograd.grad(out[0, class_idx] - out[1, class_idx], s)
    return g


def layer_deeplift(model, x, class_idx: int, baseline: Optional[torch.Tensor] = None,
                   layer: str = "layer4") -> torch.Tensor:
    """DeepLift attribution at a stage output: (C, h, w) contributions.
    x: (1, C, H, W); the baseline defaults to zeros (captum's default)."""
    if baseline is None:
        baseline = torch.zeros_like(x)
    with torch.no_grad():
        feats_pair = model(torch.cat([x, baseline]), stop_after=layer)
    g = _pair_grad(lambda f: model(f, start_from=layer), feats_pair, class_idx)
    return (feats_pair[0] - feats_pair[1]) * g[0]


def deeplift(model, x, class_idx: int, baseline: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Input-level DeepLift: (x - x0) x the multiplier chain. (C, H, W)."""
    if baseline is None:
        baseline = torch.zeros_like(x)
    g = _pair_grad(model, torch.cat([x, baseline]), class_idx)
    return (x[0] - baseline[0]) * g[0]
