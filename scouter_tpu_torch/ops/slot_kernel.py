"""The fused xSlot loop: a hand-written CUDA kernel and its plain PyTorch version.

Counterpart of ``scouter_tpu/ops/slot_pallas.py``. ``xslot_iterations_fused``
runs all ``iters`` iterations of the xSlot loop (dots, renorm, sigmoid,
weighted update, GRU) for every batch element in one launch of
``csrc/xslot_fwd.cu`` and returns the last iteration's updates (B, S, d) and
attention (B, S, N). ``xslot_iterations_ref`` is the same function written
with plain tensor ops.

The wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises. It is inference-only for now: the
checkpointed backward (``slot_pallas.py:162-211``) belongs to training, so the
wrapper refuses inputs that require grad while grad mode is on.
"""

from __future__ import annotations

import ctypes

import torch

from .gru import GRUParams

__all__ = ["xslot_iterations_fused", "xslot_iterations_ref"]


def xslot_iterations_ref(k, v, initial_slots, w_ih, w_hh, b_ih, b_hh, *, iters=3):
    """Plain PyTorch version: ``iters`` calls of ``xslot_iteration``."""
    from .slot_attention import xslot_iteration

    gru = GRUParams(w_ih=w_ih, w_hh=w_hh, b_ih=b_ih[0], b_hh=b_hh[0])
    b = k.shape[0]
    s, d = initial_slots.shape
    slots = initial_slots[None].expand(b, s, d)
    scale = float(d) ** -0.5
    updates = attn = None
    for _ in range(iters):
        slots, updates, attn = xslot_iteration(slots, k, v, gru, scale)
    return updates, attn


_SIGNATURE = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]


def _library():
    from .cuda_build import load

    lib = load("xslot_fwd")
    if lib.xslot_fwd.argtypes is None:
        lib.xslot_fwd.argtypes = _SIGNATURE
        lib.xslot_fwd.restype = ctypes.c_int
        lib.xslot_fwd_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.xslot_fwd_smem_bytes.restype = ctypes.c_size_t
        lib.xslot_fwd_max_smem.argtypes = [ctypes.c_int]
        lib.xslot_fwd_max_smem.restype = ctypes.c_int
        lib.xslot_fwd_error_string.argtypes = [ctypes.c_int]
        lib.xslot_fwd_error_string.restype = ctypes.c_char_p
    return lib


def _check_cuda_inputs(named, b, n, s, d):
    device = named["k"].device
    want = {"k": (b, n, d), "v": (b, n, d), "initial_slots": (s, d),
            "w_ih": (3 * d, d), "w_hh": (3 * d, d), "b_ih": (1, 3 * d), "b_hh": (1, 3 * d)}
    for name, t in named.items():
        if t.device != device:
            raise ValueError(f"xslot kernel: {name} is on {t.device}, k on {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"xslot kernel takes float32, {name} is {t.dtype}")
        if tuple(t.shape) != want[name]:
            raise ValueError(f"xslot kernel: {name} has shape {tuple(t.shape)}, "
                             f"expected {want[name]}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"xslot kernel: {name} must be contiguous and 16-byte aligned")
    if d % 4:
        raise ValueError(f"xslot kernel needs d % 4 == 0, got d={d}")


def xslot_iterations_fused(k, v, initial_slots, w_ih, w_hh, b_ih, b_hh, iters: int = 3):
    """Fused ``iters``-iteration xSlot loop.

    Args:
      k: (B, N, d) keys (to_k output); v: (B, N, d) values (raw features).
      initial_slots: (S, d); GRU weights in torch layout (3d, d), biases (1, 3d).
    Returns: (updates (B, S, d), attn (B, S, N)) from the final iteration.
    """
    named = dict(k=k, v=v, initial_slots=initial_slots, w_ih=w_ih, w_hh=w_hh,
                 b_ih=b_ih, b_hh=b_hh)
    if torch.is_grad_enabled() and any(t.requires_grad for t in named.values()):
        raise NotImplementedError(
            "xslot_iterations_fused has no backward yet; call it under "
            "torch.no_grad() or torch.inference_mode()")
    if all(t.device.type == "cpu" for t in named.values()):
        return xslot_iterations_ref(k, v, initial_slots, w_ih, w_hh, b_ih, b_hh, iters=iters)
    if k.device.type != "cuda":
        raise ValueError(f"xslot kernel runs on CUDA tensors, k is on {k.device}")
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    b, n, d = k.shape
    s = initial_slots.shape[0]
    _check_cuda_inputs(named, b, n, s, d)

    lib = _library()
    dev = k.device.index if k.device.index is not None else torch.cuda.current_device()
    need, have = lib.xslot_fwd_smem_bytes(n, s, d), lib.xslot_fwd_max_smem(dev)
    if need > have:
        raise ValueError(
            f"xslot kernel: S={s}, N={n}, d={d} needs {need} bytes of shared memory "
            f"per block, the card allows {have}; tiling the slots across blocks "
            "is not implemented")
    upd = torch.empty((b, s, d), dtype=torch.float32, device=k.device)
    attn = torch.empty((b, s, n), dtype=torch.float32, device=k.device)
    if b == 0:
        return upd, attn
    with torch.cuda.device(k.device):
        stream = torch.cuda.current_stream(k.device).cuda_stream
        err = lib.xslot_fwd(k.data_ptr(), v.data_ptr(), initial_slots.data_ptr(),
                            w_ih.data_ptr(), w_hh.data_ptr(), b_ih.data_ptr(), b_hh.data_ptr(),
                            upd.data_ptr(), attn.data_ptr(), b, n, s, d, iters,
                            float(d) ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"xslot kernel launch failed: CUDA error {err} "
                           f"({lib.xslot_fwd_error_string(err).decode()})")
    xslot_iterations_fused.launches += 1
    return upd, attn


# launches of the CUDA kernel (the CPU path does not count)
xslot_iterations_fused.launches = 0
