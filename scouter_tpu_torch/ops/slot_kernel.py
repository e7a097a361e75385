"""The fused xSlot loop: a hand-written CUDA kernel, its plain PyTorch
version and its checkpointed gradient.

Counterpart of ``scouter_tpu/ops/slot_pallas.py``. ``xslot_iterations_fused``
runs all ``iters`` iterations of the xSlot loop (dots, renorm, sigmoid,
weighted update, GRU) for every batch element in one launch of
``csrc/xslot_fwd.cu`` and returns the last iteration's updates (B, S, d) and
attention (B, S, N). ``xslot_fwd_ref`` is the same function written with
plain tensor ops; with ``emit_hist`` it also returns the slots entering each
iteration (B, iters, S, d), as the kernel's hist output does.

Under grad the wrapper goes through ``_XSlotFused``: the forward runs the
kernel with hist, and the backward walks the iterations in reverse,
re-deriving one iteration at a time from its hist checkpoint with plain ops
(``_bwd``, slot_pallas.py:168-208), so the backward recomputes one forward's
worth and keeps no per-iteration intermediates between the passes.

The wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises, with or without grad.
"""

from __future__ import annotations

import ctypes

import torch

from .gru import GRUParams

__all__ = ["xslot_fwd_ref", "xslot_iterations_fused", "xslot_iterations_ref"]


def xslot_fwd_ref(k, v, initial_slots, w_ih, w_hh, b_ih, b_hh, *, iters=3, emit_hist=False):
    """Plain PyTorch version of the kernel: ``iters`` calls of
    ``xslot_iteration``. Returns (upd, attn) or, with ``emit_hist``,
    (upd, attn, hist) where hist[:, i] holds the slots entering iteration i."""
    from .slot_attention import xslot_iteration

    gru = GRUParams(w_ih=w_ih, w_hh=w_hh, b_ih=b_ih[0], b_hh=b_hh[0])
    b = k.shape[0]
    s, d = initial_slots.shape
    slots = initial_slots[None].expand(b, s, d)
    scale = float(d) ** -0.5
    hist = []
    updates = attn = None
    for _ in range(iters):
        hist.append(slots)
        slots, updates, attn = xslot_iteration(slots, k, v, gru, scale)
    if emit_hist:
        return updates, attn, torch.stack(hist, dim=1)
    return updates, attn


def xslot_iterations_ref(k, v, initial_slots, w_ih, w_hh, b_ih, b_hh, *, iters=3):
    """Plain PyTorch version: ``iters`` calls of ``xslot_iteration``."""
    return xslot_fwd_ref(k, v, initial_slots, w_ih, w_hh, b_ih, b_hh, iters=iters)


_SIGNATURE = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]


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


def _launch(k, v, initial_slots, w_ih, w_hh, b_ih, b_hh, iters, emit_hist):
    """Run ``csrc/xslot_fwd.cu`` on CUDA tensors: (upd, attn[, hist])."""
    named = dict(k=k, v=v, initial_slots=initial_slots, w_ih=w_ih, w_hh=w_hh,
                 b_ih=b_ih, b_hh=b_hh)
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
    hist = (torch.empty((b, iters, s, d), dtype=torch.float32, device=k.device)
            if emit_hist else None)
    outs = (upd, attn, hist) if emit_hist else (upd, attn)
    if b == 0:
        return outs
    with torch.cuda.device(k.device):
        stream = torch.cuda.current_stream(k.device).cuda_stream
        err = lib.xslot_fwd(k.data_ptr(), v.data_ptr(), initial_slots.data_ptr(),
                            w_ih.data_ptr(), w_hh.data_ptr(), b_ih.data_ptr(), b_hh.data_ptr(),
                            upd.data_ptr(), attn.data_ptr(),
                            hist.data_ptr() if emit_hist else None,
                            b, n, s, d, iters, float(d) ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"xslot kernel launch failed: CUDA error {err} "
                           f"({lib.xslot_fwd_error_string(err).decode()})")
    xslot_iterations_fused.launches += 1
    if emit_hist:
        xslot_iterations_fused.hist_launches += 1
    return outs


class _XSlotFused(torch.autograd.Function):
    """The xSlot loop with K1's checkpointed gradient (the ``custom_vjp`` of
    slot_pallas.py:144-211)."""

    @staticmethod
    def forward(ctx, k, v, initial_slots, w_ih, w_hh, b_ih, b_hh, iters):
        args = (k, v, initial_slots, w_ih, w_hh, b_ih, b_hh)
        if all(t.device.type == "cpu" for t in args):
            upd, attn, hist = xslot_fwd_ref(*args, iters=iters, emit_hist=True)
        else:
            upd, attn, hist = _launch(*args, iters, emit_hist=True)
        ctx.save_for_backward(k, v, w_ih, w_hh, b_ih, b_hh, hist)
        ctx.iters = iters
        return upd, attn

    @staticmethod
    def backward(ctx, du, dattn):
        """``_bwd`` line for line: iteration i is rebuilt from hist[:, i] and
        its vjp taken with cotangent (dslots, du, dattn) at the last
        iteration and (dslots, 0, 0) before it; the parameter gradients add
        up across the iterations."""
        from .slot_attention import xslot_iteration

        k, v, w_ih, w_hh, b_ih, b_hh, hist = ctx.saved_tensors
        scale = float(k.shape[-1]) ** -0.5
        zero_du, zero_dattn = torch.zeros_like(du), torch.zeros_like(dattn)
        dslots = torch.zeros_like(hist[:, 0])
        sums = None
        for i in range(ctx.iters - 1, -1, -1):
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_()
                          for t in (hist[:, i], k, v, w_ih, w_hh, b_ih, b_hh)]
                slots, k_, v_, wi, wh, bi, bh = leaves
                gru = GRUParams(w_ih=wi, w_hh=wh, b_ih=bi[0], b_hh=bh[0])
                outs = xslot_iteration(slots, k_, v_, gru, scale)
                cot = ((dslots, du, dattn) if i == ctx.iters - 1
                       else (dslots, zero_du, zero_dattn))
                grads = torch.autograd.grad(outs, leaves, cot)
            dslots = grads[0]
            sums = grads[1:] if sums is None else tuple(a + g for a, g in zip(sums, grads[1:]))
        dk, dv, dwi, dwh, dbi, dbh = sums
        # the initial slots are broadcast over the batch in the forward: sum
        # the batch cotangent back down to the (S, d) parameter
        return dk, dv, dslots.sum(dim=0), dwi, dwh, dbi, dbh, None


def xslot_iterations_fused(k, v, initial_slots, w_ih, w_hh, b_ih, b_hh, iters: int = 3):
    """Fused ``iters``-iteration xSlot loop.

    Args:
      k: (B, N, d) keys (to_k output); v: (B, N, d) values (raw features).
      initial_slots: (S, d); GRU weights in torch layout (3d, d), biases (1, 3d).
    Returns: (updates (B, S, d), attn (B, S, N)) from the final iteration.

    Under grad (grad mode on and an input requiring grad) the call goes
    through the checkpointed gradient, launching the kernel with hist on CUDA
    tensors; otherwise the kernel runs without hist. CPU tensors take the
    plain version either way.
    """
    args = (k, v, initial_slots, w_ih, w_hh, b_ih, b_hh)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _XSlotFused.apply(*args, iters)
    if all(t.device.type == "cpu" for t in args):
        return xslot_iterations_ref(*args, iters=iters)
    return _launch(*args, iters, emit_hist=False)


# launches of the CUDA kernel, with and without hist (the CPU path does not
# count), and of those the launches that emitted hist
xslot_iterations_fused.launches = 0
xslot_iterations_fused.hist_launches = 0
