"""The heatmap render (K2): a hand-written CUDA kernel and its plain PyTorch
version (counterpart of ``scouter_tpu/ops/render_pallas.py``).

``render_heatmaps_fused(attn, alpha)`` turns (C, N) attention into (C, N, 4)
jet RGBA in [0, 255] in one launch of ``csrc/render_heatmaps.cu``: each row
min-max scaled to [0, 1] with denominator ``max(hi - lo, 1e-12)``, then the
analytic piecewise-linear jet of :func:`jet_rgba` with the overlay alpha
baked in, times 255. :func:`render_heatmaps_ref` is the same function in
plain tensor ops.

The scaling is per class row. The explain path's own rendering
(``explain/vis.py``) scales per sample and colours through matplotlib's
256-entry jet table, as the JAX package's does; in the JAX package this
kernel has no caller outside its test, and the port keeps it as the same
public op.

The wrapper casts to f32 and makes the input contiguous, as
render_pallas.py:60 does, and calls the ``torch.library`` custom op
``scouter_tpu_torch::render_heatmaps``: its CUDA implementation launches the
kernel (or raises), its CPU implementation is the plain version, and its fake
implementation gives the output's shape for tracing.
"""

from __future__ import annotations

import ctypes

import torch

__all__ = ["jet_rgba", "render_heatmaps_fused", "render_heatmaps_ref"]


def jet_rgba(v: torch.Tensor, alpha: float = 0.4) -> torch.Tensor:
    """Classic jet colormap on v in [0, 1] -> (..., 4) in [0, 1]."""
    r = torch.clamp(torch.minimum(4.0 * v - 1.5, -4.0 * v + 4.5), 0.0, 1.0)
    g = torch.clamp(torch.minimum(4.0 * v - 0.5, -4.0 * v + 3.5), 0.0, 1.0)
    b = torch.clamp(torch.minimum(4.0 * v + 0.5, -4.0 * v + 2.5), 0.0, 1.0)
    a = torch.full_like(v, alpha)
    return torch.stack([r, g, b, a], dim=-1)


def render_heatmaps_ref(attn: torch.Tensor, alpha: float = 0.4) -> torch.Tensor:
    """Plain PyTorch version of the kernel's math."""
    lo = attn.amin(dim=1, keepdim=True)
    hi = attn.amax(dim=1, keepdim=True)
    scaled = (attn - lo) / torch.clamp_min(hi - lo, 1e-12)
    return jet_rgba(scaled, alpha) * 255.0


def _library():
    from .cuda_build import load

    lib = load("render_heatmaps")
    if lib.render_heatmaps.argtypes is None:
        lib.render_heatmaps.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        lib.render_heatmaps.restype = ctypes.c_int
        lib.render_heatmaps_error_string.argtypes = [ctypes.c_int]
        lib.render_heatmaps_error_string.restype = ctypes.c_char_p
    return lib


@torch.library.custom_op("scouter_tpu_torch::render_heatmaps", mutates_args=(),
                         device_types="cuda")
def _render_op(attn: torch.Tensor, alpha: float) -> torch.Tensor:
    """K2 on a contiguous f32 (C, N) tensor: (C, N, 4) f32."""
    return _launch(attn, alpha)


@_render_op.register_kernel("cpu")
def _(attn, alpha):
    return render_heatmaps_ref(attn, alpha)


@_render_op.register_fake
def _(attn, alpha):
    return attn.new_empty((*attn.shape, 4), dtype=torch.float32)


def _launch(attn: torch.Tensor, alpha: float) -> torch.Tensor:
    """Run ``csrc/render_heatmaps.cu`` on a contiguous f32 CUDA (C, N) tensor."""
    if attn.device.type != "cuda":
        raise ValueError(f"render kernel runs on CUDA tensors, attn is on {attn.device}")
    c, n = attn.shape
    out = torch.empty((c, n, 4), dtype=torch.float32, device=attn.device)
    if c == 0:
        return out
    lib = _library()
    with torch.cuda.device(attn.device):
        stream = torch.cuda.current_stream(attn.device).cuda_stream
        err = lib.render_heatmaps(attn.data_ptr(), out.data_ptr(), c, n, alpha, stream)
    if err != 0:
        raise RuntimeError(f"render kernel launch failed: CUDA error {err} "
                           f"({lib.render_heatmaps_error_string(err).decode()})")
    render_heatmaps_fused.launches += 1
    return out


def render_heatmaps_fused(attn: torch.Tensor, alpha: float = 0.4) -> torch.Tensor:
    """(C, N) attention -> (C, N, 4) jet RGBA in [0, 255], one kernel launch.

    Per-class min-max scaling: each class row is normalised on its own."""
    if attn.dim() != 2:
        raise ValueError(f"attn must be (C, N), got shape {tuple(attn.shape)}")
    if attn.shape[1] == 0:
        raise ValueError("attn rows are empty (N = 0): min and max are undefined")
    return _render_op(attn.to(torch.float32).contiguous(), float(alpha))


# launches of the CUDA kernel (the CPU path does not count)
render_heatmaps_fused.launches = 0
