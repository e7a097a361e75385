"""The fused xSlot loop: hand-written CUDA kernels for its forward and its
checkpointed backward, their plain PyTorch versions and the autograd op.

Counterpart of ``scouter_tpu/ops/slot_pallas.py``. ``xslot_iterations_fused``
runs all ``iters`` iterations of the xSlot loop (dots, renorm, sigmoid,
weighted update, GRU) for every batch element in one launch of
``csrc/xslot_fwd.cu`` and returns the last iteration's updates (B, S, d) and
attention (B, S, N) in float32. Its inputs are all float32 or all bfloat16;
bfloat16 is converted to float32 on load and everything after is float32, as
the Pallas kernel does with ``preferred_element_type=float32``.
``xslot_fwd_ref`` is the same function in plain tensor ops; with
``emit_hist`` it also returns the slots entering each iteration
(B, iters, S, d), as the kernel's hist output does.

Under grad the wrapper goes through ``_XSlotFused``: the forward runs the
kernel with hist, and the backward runs ``csrc/xslot_bwd.cu``, which walks
the iterations in reverse and rebuilds each one from its hist checkpoint
(``_bwd``, slot_pallas.py:168-208). ``xslot_bwd_ref`` writes the same
gradient formulas out by hand in plain ops, in the kernel's order; it is the
backward's CPU path.

Each batch element runs on one thread-block cluster of ``c`` CTAs that split
its slots; ``_plan`` chooses ``c``. Where the backward's share of an element
does not fit in a cluster of 8 (S=1000 at N=81, N=196 at S=30), it takes its
tiled route instead: each iteration a chain of launches over the batch, with
its intermediates in device memory. The wrapper takes the plain versions only
for tensors on the CPU; for CUDA tensors it launches the kernels or raises,
with or without grad.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .gru import GRUParams

__all__ = ["Plan", "xslot_bwd_ref", "xslot_fwd_ref", "xslot_iterations_fused",
           "xslot_iterations_ref"]

# csrc/xslot_common.cuh: threads per CTA, columns per staged GRU weight tile
# and the portable cluster limit
_THREADS = 256
_TILE_C = 8
_MAX_CLUSTER = 8


def _input_dtype(tensors):
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1 or not dtypes <= {torch.float32, torch.bfloat16}:
        raise TypeError("xslot kernel takes its inputs all in float32 or all in bfloat16, "
                        f"got {sorted(map(str, dtypes))}")
    return dtypes.pop()


def xslot_fwd_ref(k, v, initial_slots, w_ih, w_hh, b_ih, b_hh, *, iters=3, emit_hist=False):
    """Plain PyTorch version of the forward kernel: ``iters`` calls of
    ``xslot_iteration`` on the inputs, bfloat16 ones upcast to float32.
    Returns (upd, attn) or, with ``emit_hist``, (upd, attn, hist) where
    hist[:, i] holds the slots entering iteration i."""
    from .slot_attention import xslot_iteration

    k, v, initial_slots, w_ih, w_hh, b_ih, b_hh = (
        t.float() if t.dtype == torch.bfloat16 else t
        for t in (k, v, initial_slots, w_ih, w_hh, b_ih, b_hh))
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


def xslot_bwd_ref(k, v, w_ih, w_hh, b_ih, b_hh, hist, du, dattn):
    """Plain PyTorch version of the backward kernel, written out by hand.

    Given the residuals (k, v, the GRU weights and biases, hist (B, iters,
    S, d)) and the cotangents of the last iteration's updates and attention,
    returns (dk, dv, d_initial_slots, dW_ih, dW_hh, db_ih, db_hh). Iteration i
    is rebuilt from hist[:, i]; its cotangent is (dslots, du, dattn) at the
    last iteration and (dslots, 0, 0) before it. The last iteration's GRU
    output is unused, so its backward is skipped."""
    b, iters, s, d = hist.shape
    scale = float(d) ** -0.5
    bi, bh = b_ih[0], b_hh[0]
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    dwi, dwh = torch.zeros_like(w_ih), torch.zeros_like(w_hh)
    dbi, dbh = torch.zeros_like(b_ih), torch.zeros_like(b_hh)
    dslots = torch.zeros_like(hist[:, 0])
    for i in range(iters - 1, -1, -1):
        h = hist[:, i]
        dots = torch.einsum("bsd,bnd->bsn", h, k) * scale
        rs = dots.sum(dim=2, keepdim=True)
        total = dots.sum(dim=(1, 2), keepdim=True)
        attn = torch.sigmoid(dots / rs * total)
        upd = torch.einsum("bsn,bnd->bsd", attn, v) / d
        if i == iters - 1:
            dupd, dh = du, None
            dattn_tot = dattn + torch.einsum("bsd,bnd->bsn", dupd, v) / d
        else:
            # GRU: x = upd, h entering, g the cotangent of the new slots
            g = dslots
            gi = upd @ w_ih.T + bi
            gh = h @ w_hh.T + bh
            r = torch.sigmoid(gi[..., :d] + gh[..., :d])
            z = torch.sigmoid(gi[..., d:2 * d] + gh[..., d:2 * d])
            n = torch.tanh(gi[..., 2 * d:] + r * gh[..., 2 * d:])
            dn, dz, dh = g * (1 - z), g * (h - n), g * z
            a_n = dn * (1 - n * n)
            a_r = a_n * gh[..., 2 * d:] * r * (1 - r)
            a_z = dz * z * (1 - z)
            dgi = torch.cat([a_r, a_z, a_n], dim=-1)
            dgh = torch.cat([a_r, a_z, a_n * r], dim=-1)
            dupd = dgi @ w_ih
            dh = dh + dgh @ w_hh
            dwi = dwi + torch.einsum("bsr,bsc->rc", dgi, upd)
            dwh = dwh + torch.einsum("bsr,bsc->rc", dgh, h)
            dbi = dbi + dgi.sum(dim=(0, 1))[None]
            dbh = dbh + dgh.sum(dim=(0, 1))[None]
            dattn_tot = torch.einsum("bsd,bnd->bsn", dupd, v) / d
        dv = dv + torch.einsum("bsn,bsd->bnd", attn, dupd) / d
        # renorm x = dots * total / rs, with total the sum of all the dots
        grad_x = dattn_tot * attn * (1 - attn)
        rg = (grad_x * dots).sum(dim=2, keepdim=True)
        q = (rg / rs).sum(dim=(1, 2), keepdim=True)
        ddots = (total * grad_x / rs - total * rg / (rs * rs) + q) * scale
        dh_att = torch.einsum("bsn,bnd->bsd", ddots, k)
        dk = dk + torch.einsum("bsn,bsd->bnd", ddots, h)
        dslots = dh_att if dh is None else dh + dh_att
    return dk, dv, dslots.sum(dim=0), dwi, dwh, dbi, dbh


class Plan(NamedTuple):
    """How one launch splits the work: a cluster of ``cluster`` CTAs per
    batch element, each owning at most ``slots_per_cta`` slots, with
    ``smem_bytes`` of dynamic shared memory; ``resident``: all of the GRU
    weights in shared memory (else they stream through it in tiles);
    ``clusters``: how many such clusters the card holds at once, and
    ``ctas_per_sm`` the CTAs that makes on one SM when it is full. The
    backward's tiled route is ``cluster`` 0 (``TILED``)."""

    cluster: int
    slots_per_cta: int
    smem_bytes: int
    ctas_per_sm: int
    resident: bool
    clusters: int

    @property
    def tiled(self) -> bool:
        return self.cluster == 0


TILED = Plan(0, 0, 0, 0, False, 0)


def _smem_bytes(kind: str, n: int, s_cta: int, d: int, resident: bool = False) -> int:
    """Dynamic shared memory of one CTA owning ``s_cta`` slots, as the
    layouts of ``csrc/xslot_fwd.cu`` and ``csrc/xslot_bwd.cu`` have it. The
    card's plan takes the libraries' own ``xslot_*_smem_bytes``; this copy is
    for planning without a card, and ``chip_smoke.py`` holds it to them. Only
    the forward keeps the weights resident."""
    slp = -(-s_cta // 4) * 4
    ld = d + 4
    weights = 2 * 3 * d * (d + 4) if resident else 4 * 3 * d * (_TILE_C + 4)
    if kind == "fwd":
        floats = 2 * n * ld + 3 * slp * ld + slp * n + 2 * slp + weights
    else:
        floats = 2 * n * ld + 2 * n * d + 5 * slp * ld + 3 * slp * n + 3 * slp + 6 * slp * d + weights
    return 4 * floats


def _plan(b: int, n: int, s: int, d: int, kind: str, max_smem: int, sms: int, smem,
          active) -> Plan:
    """The cluster size for ``kind`` ('fwd' or 'bwd') at (B, N, S, d) on a
    card with ``max_smem`` bytes of opt-in shared memory per CTA and ``sms``
    SMs. ``smem(s_cta, resident)`` is one CTA's shared memory when it owns
    ``s_cta`` slots, and ``active(c, s_cta, resident)`` how many clusters
    of ``c`` such CTAs the card holds at once
    (cudaOccupancyMaxActiveClusters). Takes the smallest ``c`` whose share
    of the slots fits, raised while the launch still fits in one wave (B
    clusters at once: the SMs of a cluster share one GPC), ``c`` <= 8 and
    ``c`` <= S. The forward keeps the GRU weights resident where they fit
    beside its share. Where 8 CTAs cannot hold the shares the backward takes
    its tiled route (``TILED``) and the forward raises ``ValueError``."""
    top = min(_MAX_CLUSTER, s)

    def share(c):
        return -(-s // c)

    def footprint(c):  # (bytes, resident)
        if kind == "fwd" and smem(share(c), True) <= max_smem:
            return smem(share(c), True), True
        return smem(share(c), False), False

    def clusters(c):
        nbytes, resident = footprint(c)
        return active(c, share(c), resident) if nbytes <= max_smem else 0

    fits = [c for c in range(1, top + 1) if clusters(c) > 0]
    if not fits and kind == "bwd":
        return TILED
    if not fits:
        raise ValueError(
            f"xslot {kind} kernel: S={s}, N={n}, d={d} needs {footprint(top)[0]} bytes of "
            f"shared memory per CTA even split over a cluster of {top} CTAs; the card "
            f"allows {max_smem} and a portable cluster at most {_MAX_CLUSTER} CTAs")
    c = fits[0]
    while c < top and b <= clusters(c + 1):
        c += 1
    nbytes, resident = footprint(c)
    return Plan(c, share(c), nbytes, -(-clusters(c) * c // sms), resident, clusters(c))


_FWD_SIGNATURE = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                  + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
_BWD_SIGNATURE = ([ctypes.c_void_p] * 17 + [ctypes.c_int] * 5
                  + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def _library(name: str):
    from .cuda_build import load

    lib = load(name)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = _FWD_SIGNATURE if name == "xslot_fwd" else _BWD_SIGNATURE
        fn.restype = ctypes.c_int
        smem = getattr(lib, f"{name}_smem_bytes")
        smem.argtypes = [ctypes.c_int] * (4 if name == "xslot_fwd" else 3)
        smem.restype = ctypes.c_size_t
        clusters = getattr(lib, f"{name}_max_clusters")
        clusters.argtypes = [ctypes.c_int] * (6 if name == "xslot_fwd" else 4)
        clusters.restype = ctypes.c_int
        if name == "xslot_bwd":
            lib.xslot_bwd_scratch_floats.argtypes = [ctypes.c_int] * 5
            lib.xslot_bwd_scratch_floats.restype = ctypes.c_size_t
        lib.xslot_max_smem.argtypes = [ctypes.c_int]
        lib.xslot_max_smem.restype = ctypes.c_int
        lib.xslot_error_string.argtypes = [ctypes.c_int]
        lib.xslot_error_string.restype = ctypes.c_char_p
    return lib


def _check_cuda_inputs(named, want, dtype):
    device = next(iter(named.values())).device
    if device.type != "cuda":
        raise ValueError(f"xslot kernel runs on CUDA tensors, k is on {device}")
    for name, t in named.items():
        if t.device != device:
            raise ValueError(f"xslot kernel: {name} is on {t.device}, k on {device}")
        if t.dtype != dtype:
            raise TypeError(f"xslot kernel: {name} is {t.dtype}, expected {dtype}")
        if tuple(t.shape) != want[name]:
            raise ValueError(f"xslot kernel: {name} has shape {tuple(t.shape)}, "
                             f"expected {want[name]}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"xslot kernel: {name} must be contiguous and 16-byte aligned")


def _check_dim(d):
    # rows are loaded four floats at a time, and the GRU's thread tile gives
    # each of a CTA's threads at most one column quad
    if d % 4 or not 4 <= d <= 4 * _THREADS:
        raise ValueError(f"xslot kernel needs d a multiple of 4 up to {4 * _THREADS}, got d={d}")


def launch_plan(kind: str, b: int, n: int, s: int, d: int, device, bf16: bool = False) -> Plan:
    """``_plan`` for the card that holds ``device``, with its own count of
    the clusters it holds at once. The backward plans where the forward
    does (it reads the forward's hist): past the forward's limit its tiled
    route raises the forward's ``ValueError``."""
    dev = device.index if device.index is not None else torch.cuda.current_device()
    return _device_plan(kind, b, n, s, d, dev, bf16)


@functools.lru_cache(maxsize=256)
def _device_plan(kind, b, n, s, d, dev, bf16):
    lib = _library(f"xslot_{kind}")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def smem(s_cta, resident):
        return (lib.xslot_fwd_smem_bytes(n, s_cta, d, int(resident)) if kind == "fwd"
                else lib.xslot_bwd_smem_bytes(n, s_cta, d))

    def active(c, s_cta, resident):
        with torch.cuda.device(dev):
            got = (lib.xslot_fwd_max_clusters(n, s_cta, d, int(resident), int(bf16), c)
                   if kind == "fwd" else lib.xslot_bwd_max_clusters(n, s_cta, d, c))
        if got < 0:
            _raise_on(lib, -got, f"xslot {kind} occupancy query")
        return got

    plan = _plan(b, n, s, d, kind, lib.xslot_max_smem(dev), sms, smem, active)
    if plan.tiled:
        _device_plan("fwd", b, n, s, d, dev, False)
    return plan


def _raise_on(lib, err, what):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: error {err} "
                           f"({lib.xslot_error_string(err).decode()})")


def _launch(k, v, initial_slots, w_ih, w_hh, b_ih, b_hh, iters, emit_hist):
    """Run ``csrc/xslot_fwd.cu`` on CUDA tensors: (upd, attn[, hist]), float32."""
    named = dict(k=k, v=v, initial_slots=initial_slots, w_ih=w_ih, w_hh=w_hh,
                 b_ih=b_ih, b_hh=b_hh)
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    b, n, d = k.shape
    s = initial_slots.shape[0]
    dtype = _input_dtype(named.values())
    _check_cuda_inputs(named, {"k": (b, n, d), "v": (b, n, d), "initial_slots": (s, d),
                               "w_ih": (3 * d, d), "w_hh": (3 * d, d), "b_ih": (1, 3 * d),
                               "b_hh": (1, 3 * d)}, dtype)
    _check_dim(d)
    plan = launch_plan("fwd", b, n, s, d, k.device, dtype == torch.bfloat16)
    upd = torch.empty((b, s, d), dtype=torch.float32, device=k.device)
    attn = torch.empty((b, s, n), dtype=torch.float32, device=k.device)
    hist = (torch.empty((b, iters, s, d), dtype=torch.float32, device=k.device)
            if emit_hist else None)
    outs = (upd, attn, hist) if emit_hist else (upd, attn)
    if b == 0:
        return outs
    lib = _library("xslot_fwd")
    with torch.cuda.device(k.device):
        stream = torch.cuda.current_stream(k.device).cuda_stream
        err = lib.xslot_fwd(k.data_ptr(), v.data_ptr(), initial_slots.data_ptr(),
                            w_ih.data_ptr(), w_hh.data_ptr(), b_ih.data_ptr(), b_hh.data_ptr(),
                            upd.data_ptr(), attn.data_ptr(),
                            hist.data_ptr() if emit_hist else None,
                            b, n, s, d, iters, float(d) ** -0.5,
                            int(dtype == torch.bfloat16), plan.cluster, int(plan.resident),
                            stream)
    _raise_on(lib, err, "xslot forward kernel")
    xslot_iterations_fused.launches += 1
    if emit_hist:
        xslot_iterations_fused.hist_launches += 1
    return outs


def _launch_bwd(k, v, w_ih, w_hh, b_ih, b_hh, hist, du, dattn):
    """Run ``csrc/xslot_bwd.cu`` on CUDA tensors: the gradient kernel, then
    the fixed-order sum of its per-CTA partials over the batch. Returns what
    ``xslot_bwd_ref`` returns."""
    b, n, d = k.shape
    iters, s = hist.shape[1], hist.shape[2]
    named = dict(k=k, v=v, w_ih=w_ih, w_hh=w_hh, b_ih=b_ih, b_hh=b_hh, hist=hist, du=du,
                 dattn=dattn)
    _check_cuda_inputs(named, {"k": (b, n, d), "v": (b, n, d), "w_ih": (3 * d, d),
                               "w_hh": (3 * d, d), "b_ih": (1, 3 * d), "b_hh": (1, 3 * d),
                               "hist": (b, iters, s, d), "du": (b, s, d),
                               "dattn": (b, s, n)}, torch.float32)
    _check_dim(d)
    plan = launch_plan("bwd", b, n, s, d, k.device)
    grads = (torch.empty_like(k), torch.empty_like(v), torch.empty((s, d), device=k.device),
             torch.empty_like(w_ih), torch.empty_like(w_hh), torch.empty_like(b_ih),
             torch.empty_like(b_hh))
    if b == 0:
        return tuple(g.zero_() for g in grads)
    lib = _library("xslot_bwd")
    scratch = torch.empty(lib.xslot_bwd_scratch_floats(b, n, s, d, plan.cluster),
                          dtype=torch.float32, device=k.device)
    with torch.cuda.device(k.device):
        stream = torch.cuda.current_stream(k.device).cuda_stream
        err = lib.xslot_bwd(*(t.data_ptr() for t in named.values()),
                            *(g.data_ptr() for g in grads), scratch.data_ptr(),
                            b, n, s, d, iters, float(d) ** -0.5, plan.cluster, stream)
    _raise_on(lib, err, "xslot backward kernel")
    if plan.tiled:
        xslot_iterations_fused.bwd_tiled_launches += 1
    else:
        xslot_iterations_fused.bwd_launches += 1
    return grads


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
        return upd, attn

    @staticmethod
    def backward(ctx, du, dattn):
        """``_bwd``: the backward kernel on CUDA tensors, ``xslot_bwd_ref``
        on CPU tensors."""
        saved = ctx.saved_tensors
        if all(t.device.type == "cpu" for t in saved):
            grads = xslot_bwd_ref(*saved, du, dattn)
        else:
            grads = _launch_bwd(*saved, du.contiguous(), dattn.contiguous())
        return (*grads, None)


def xslot_iterations_fused(k, v, initial_slots, w_ih, w_hh, b_ih, b_hh, iters: int = 3):
    """Fused ``iters``-iteration xSlot loop.

    Args:
      k: (B, N, d) keys (to_k output); v: (B, N, d) values (raw features).
      initial_slots: (S, d); GRU weights in torch layout (3d, d), biases (1, 3d).
      All in float32, or all in bfloat16 (inference only).
    Returns: (updates (B, S, d), attn (B, S, N)) from the final iteration, in
    float32.

    Under grad (grad mode on and an input requiring grad) the call goes
    through the checkpointed gradient, launching the forward kernel with hist
    and the backward kernel on CUDA tensors; otherwise the forward kernel
    runs without hist. CPU tensors take the plain versions either way.

    Limits of the CUDA kernels, each raising ``ValueError``: d a multiple of
    4 up to 1024; each CTA of a cluster of at most 8 holds all of k and v
    and its share of the slots in shared memory, so at d=64 the forward runs
    up to N=343 at S=30 and S=1024 at N=81 (S=416 at N=196). The backward
    runs wherever the forward does: on a cluster where its share fits (at
    d=64 up to N=166 at S=30 and S=125 at N=81), else on its tiled route.
    """
    args = (k, v, initial_slots, w_ih, w_hh, b_ih, b_hh)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        if any(t.dtype == torch.bfloat16 for t in args):
            raise TypeError("the xslot gradient is float32 only; bfloat16 slot heads are "
                            "for inference")
        return _XSlotFused.apply(*args, iters)
    if all(t.device.type == "cpu" for t in args):
        return xslot_iterations_ref(*args, iters=iters)
    return _launch(*args, iters, emit_hist=False)


# launches of the forward kernel, with and without hist (the CPU path does not
# count), of those the launches that emitted hist, calls of the backward
# kernel on a cluster (each one gradient launch and its fixed-order sum) and
# calls of its tiled route (each its chain of launches)
xslot_iterations_fused.launches = 0
xslot_iterations_fused.hist_launches = 0
xslot_iterations_fused.bwd_launches = 0
xslot_iterations_fused.bwd_tiled_launches = 0
