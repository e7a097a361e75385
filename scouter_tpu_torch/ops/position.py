"""DETR-style sine position embedding (counterpart of ``scouter_tpu/ops/position.py``).

``PositionEmbeddingSine`` with ``normalize=True``, ``scale=2*pi`` and
``temperature=10000``, as the reference builds it for ``hidden_dim``
(``N_steps = hidden_dim // 2`` features per spatial axis). Returned as
``(h, w, hidden_dim)`` with the channel order ``[y-features, x-features]``.
"""

from __future__ import annotations

import math

import torch

__all__ = ["sine_position_embedding"]


def _interleave_sin_cos(pos: torch.Tensor) -> torch.Tensor:
    """[sin(p0), cos(p1), sin(p2), cos(p3), ...] over the last axis."""
    out = torch.stack([pos[..., 0::2].sin(), pos[..., 1::2].cos()], dim=-1)
    return out.flatten(-2)


def sine_position_embedding(
    h: int,
    w: int,
    hidden_dim: int,
    *,
    temperature: float = 10000.0,
    scale: float = 2.0 * math.pi,
    eps: float = 1e-6,
    dtype: torch.dtype = torch.float32,
    device="cpu",
) -> torch.Tensor:
    """Return the (h, w, hidden_dim) sine position embedding.

    ``hidden_dim`` must be divisible by 4: the sin/cos interleave splits each
    axis's ``hidden_dim // 2`` features into equal even/odd halves.
    """
    if hidden_dim % 4 != 0:
        raise ValueError(f"hidden_dim must be divisible by 4, got {hidden_dim}")
    num_pos_feats = hidden_dim // 2
    f32 = dict(dtype=torch.float32, device=device)
    # cumsum of an all-ones mask is 1..h / 1..w, normalised by the last value
    y_embed = torch.arange(1, h + 1, **f32) / (float(h) + eps) * scale
    x_embed = torch.arange(1, w + 1, **f32) / (float(w) + eps) * scale

    idx = torch.arange(num_pos_feats, **f32)
    dim_t = torch.pow(torch.tensor(temperature, **f32),
                      2.0 * torch.floor(idx / 2.0) / num_pos_feats)

    pos_x = _interleave_sin_cos(x_embed[None, :, None] / dim_t)  # (1, w, npf)
    pos_y = _interleave_sin_cos(y_embed[:, None, None] / dim_t)  # (h, 1, npf)
    pos_x = pos_x.expand(h, w, num_pos_feats)
    pos_y = pos_y.expand(h, w, num_pos_feats)
    return torch.cat([pos_y, pos_x], dim=-1).to(dtype)
