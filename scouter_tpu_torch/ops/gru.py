"""GRU cell with torch gate semantics (counterpart of ``scouter_tpu/ops/gru.py``).

The reference updates slot state with a single-layer ``nn.GRU(dim, dim)`` on a
length-1 sequence, which is one GRU cell step per slot:

    r = sigmoid(x @ W_ir^T + b_ir + h @ W_hr^T + b_hr)
    z = sigmoid(x @ W_iz^T + b_iz + h @ W_hz^T + b_hz)
    n = tanh  (x @ W_in^T + b_in + r * (h @ W_hn^T + b_hn))
    h' = (1 - z) * n + z * h

Weights are in torch layout: ``w_ih``/``w_hh`` (3d, d) with gate order
(r, z, n), biases (3d,).
"""

from __future__ import annotations

from typing import TypedDict

import torch

__all__ = ["GRUParams", "gru_cell", "init_gru_params"]


class GRUParams(TypedDict):
    w_ih: torch.Tensor  # (3d, d)
    w_hh: torch.Tensor  # (3d, d)
    b_ih: torch.Tensor  # (3d,)
    b_hh: torch.Tensor  # (3d,)


def init_gru_params(generator: torch.Generator, dim: int,
                    dtype: torch.dtype = torch.float32) -> GRUParams:
    """U(-1/sqrt(d), 1/sqrt(d)), torch's ``nn.GRU`` default, drawn from
    ``generator`` in the order w_ih, w_hh, b_ih, b_hh."""
    bound = 1.0 / dim ** 0.5

    def u(*shape):
        return torch.empty(shape, dtype=dtype).uniform_(-bound, bound, generator=generator)

    return GRUParams(w_ih=u(3 * dim, dim), w_hh=u(3 * dim, dim), b_ih=u(3 * dim),
                     b_hh=u(3 * dim))


def gru_cell(params: GRUParams, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """One GRU step. x, h: (..., d) -> (..., d)."""
    gi = x @ params["w_ih"].T + params["b_ih"]
    gh = h @ params["w_hh"].T + params["b_hh"]
    i_r, i_z, i_n = gi.chunk(3, dim=-1)
    h_r, h_z, h_n = gh.chunk(3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1.0 - z) * n + z * h
