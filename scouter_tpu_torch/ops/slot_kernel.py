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
backward's CPU path. bfloat16 inputs train too (a bf16 slot head): hist and
the cotangents are float32, the backward converts the bf16 residuals to
float32 exactly, computes in float32 and rounds each gradient once to
bfloat16. JAX's own fused op cannot take bf16 under grad (slot_pallas.py:58
stores bf16 slots into its f32 hist); its bf16 head trains on the jnp path
in bf16 arithmetic, so the port's bf16 gradient lies closer to float64.

Each launch goes through a ``torch.library`` custom op of the namespace
``scouter_tpu_torch`` (``xslot_fwd``, ``xslot_fwd_hist``, ``xslot_bwd``):
its CUDA implementation launches the kernel, its CPU implementation is the
plain version, and its fake implementation gives the outputs' shapes and
dtypes, so ``torch.export`` traces the slot head (ctypes it cannot trace).

Each batch element runs on one thread-block cluster of ``c`` CTAs that split
its slots; ``_plan`` chooses ``c``. Where an element's share does not fit in a
cluster of 8 (or d > 1024), each kernel takes its tiled route instead. The
backward's is a chain of launches over the batch with its intermediates in
device memory (``csrc/xslot_bwd.cu``: S=1000 at N=81, N=196 at S=30). The
forward's is one launch of ``csrc/xslot_fwd_tiled.cu``: a cluster of up to
16 CTAs an element that split its slots and its positions
(``split_fwd_plan``), at N=784 at S=30 (output stride 8) and S=1000 at
N=196 (the CUB recipe at 448 px). The route is chosen by shape alone, never
after a launch failed. A slot width that is not a multiple of 4 runs
zero-padded to one (``pad_slot_width``), exactly. The wrapper takes the
plain versions only for tensors on the CPU; for CUDA tensors it launches the
kernels or raises, with or without grad.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Tuple

import torch

from .gru import GRUParams

__all__ = ["Plan", "SplitFwdPlan", "TiledPlan", "TiledProduct", "pad_slot_width",
           "split_fwd_plan", "tiled_plan", "xslot_bwd_ref", "xslot_fwd_ref",
           "xslot_iterations_fused", "xslot_iterations_ref"]

# csrc/xslot_common.cuh: threads per CTA, columns per staged GRU weight tile
# and the portable cluster limit; csrc/xslot_bwd.cu: the most 4 x 4 tiles
# of dk and of dv a thread of the cluster backward holds in registers
_THREADS = 256
_TILE_C = 8
_MAX_CLUSTER = 8
_KV_TILES = 3


def _input_dtype(tensors):
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1 or not dtypes <= {torch.float32, torch.bfloat16}:
        raise TypeError("xslot kernel takes its inputs all in float32 or all in bfloat16, "
                        f"got {sorted(map(str, dtypes))}")
    return dtypes.pop()


def xslot_fwd_ref(k, v, initial_slots, w_ih, w_hh, b_ih, b_hh, *, iters=3, emit_hist=False,
                  dim=None):
    """Plain PyTorch version of the forward kernel: ``iters`` calls of
    ``xslot_iteration`` on the inputs, bfloat16 ones upcast to float32.
    Returns (upd, attn) or, with ``emit_hist``, (upd, attn, hist) where
    hist[:, i] holds the slots entering iteration i. ``dim``: the true slot
    width of inputs zero-padded past it (``pad_slot_width``), which the
    scale and the updates' divisor take."""
    from .slot_attention import xslot_iteration

    k, v, initial_slots, w_ih, w_hh, b_ih, b_hh = (
        t.float() if t.dtype == torch.bfloat16 else t
        for t in (k, v, initial_slots, w_ih, w_hh, b_ih, b_hh))
    gru = GRUParams(w_ih=w_ih, w_hh=w_hh, b_ih=b_ih[0], b_hh=b_hh[0])
    b = k.shape[0]
    s, d = initial_slots.shape
    slots = initial_slots[None].expand(b, s, d)
    dim = d if dim is None else dim
    scale = float(dim) ** -0.5
    hist = []
    updates = attn = None
    for _ in range(iters):
        hist.append(slots)
        slots, updates, attn = xslot_iteration(slots, k, v, gru, scale, dim)
    if emit_hist:
        return updates, attn, torch.stack(hist, dim=1)
    return updates, attn


def xslot_iterations_ref(k, v, initial_slots, w_ih, w_hh, b_ih, b_hh, *, iters=3):
    """Plain PyTorch version: ``iters`` calls of ``xslot_iteration``."""
    return xslot_fwd_ref(k, v, initial_slots, w_ih, w_hh, b_ih, b_hh, iters=iters)


def xslot_bwd_ref(k, v, w_ih, w_hh, b_ih, b_hh, hist, du, dattn, *, dim=None):
    """Plain PyTorch version of the backward kernel, written out by hand.

    Given the residuals (k, v, the GRU weights and biases, hist (B, iters,
    S, d)) and the cotangents of the last iteration's updates and attention,
    returns (dk, dv, d_initial_slots, dW_ih, dW_hh, db_ih, db_hh). Iteration i
    is rebuilt from hist[:, i]; its cotangent is (dslots, du, dattn) at the
    last iteration and (dslots, 0, 0) before it. The last iteration's GRU
    output is unused, so its backward is skipped. bfloat16 residuals (with
    float32 hist and cotangents) are upcast, the arithmetic is float32, and
    the gradients are cast back to bfloat16 once, at the end. ``dim`` as
    ``xslot_fwd_ref`` takes it."""
    if k.dtype == torch.bfloat16:
        grads = xslot_bwd_ref(*(t.float() for t in (k, v, w_ih, w_hh, b_ih, b_hh)), hist, du,
                              dattn, dim=dim)
        return tuple(g.to(torch.bfloat16) for g in grads)
    b, iters, s, d = hist.shape
    div = d if dim is None else dim
    scale = float(div) ** -0.5
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
        upd = torch.einsum("bsn,bnd->bsd", attn, v) / div
        if i == iters - 1:
            dupd, dh = du, None
            dattn_tot = dattn + torch.einsum("bsd,bnd->bsn", dupd, v) / div
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
            dattn_tot = torch.einsum("bsd,bnd->bsn", dupd, v) / div
        dv = dv + torch.einsum("bsn,bsd->bnd", attn, dupd) / div
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
    ``ctas_per_sm`` the CTAs that makes on one SM when it is full. A tiled
    route is ``cluster`` 0 (``TILED``)."""

    cluster: int
    slots_per_cta: int
    smem_bytes: int
    ctas_per_sm: int
    resident: bool
    clusters: int

    @property
    def tiled(self) -> bool:
        return self.cluster == 0

    def launches(self, kind: str) -> int:
        """Launches of one call on this cluster plan: the forward's kernel,
        or the backward's gradient kernel and its fixed-order sum. The tiled
        routes' counts are ``SplitFwdPlan.launches`` and
        ``TiledPlan.launches``."""
        if self.tiled:
            raise ValueError("the tiled routes' launches are SplitFwdPlan.launches and "
                             "TiledPlan.launches")
        return 1 if kind == "fwd" else 2


TILED = Plan(0, 0, 0, 0, False, 0)


def _smem_bytes(kind: str, n: int, s_cta: int, d: int, resident: bool = False) -> int:
    """Dynamic shared memory of one CTA owning ``s_cta`` slots, as the
    layouts of ``csrc/xslot_fwd.cu`` and ``csrc/xslot_bwd.cu`` have it. The
    card's plan takes the libraries' own ``xslot_*_smem_bytes``; this copy is
    for planning without a card, and ``chip_smoke.py`` holds it to them. The
    forward keeps the GRU weights resident where they fit (else it streams
    them in tiles); the backward always keeps them resident."""
    slp = -(-s_cta // 4) * 4
    ld = d + 4
    weights = 2 * 3 * d * (d + 4) if resident else 4 * 3 * d * (_TILE_C + 4)
    if kind == "fwd":
        floats = 2 * n * ld + 3 * slp * ld + slp * n + 2 * slp + weights
    else:
        n4 = -(-n // 4) * 4  # k, v and the (slots, N) buffers padded to a multiple of 4
        floats = (2 * n4 * ld + 4 * slp * ld + 3 * slp * n4 + 3 * slp + 4 * slp * d + 6 * d
                  + weights)
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
    beside its share; the backward always does, and holds dk and dv in
    registers, ``_KV_TILES`` 4 x 4 tiles of each a thread at most. Where 8
    CTAs cannot hold the shares (or a thread dk and dv), and past d=1024
    (the GRU's thread tile gives each thread at most one column quad), the
    kernel takes its tiled route (``TILED``)."""
    if d > 4 * _THREADS:
        return TILED
    top = min(_MAX_CLUSTER, s)
    kv_fits = kind == "fwd" or -(-n // 4) * (d // 4) <= _KV_TILES * _THREADS

    def share(c):
        return -(-s // c)

    def footprint(c):  # (bytes, resident)
        if kind == "bwd" or smem(share(c), True) <= max_smem:
            return smem(share(c), True), True
        return smem(share(c), False), False

    def clusters(c):
        nbytes, resident = footprint(c)
        return active(c, share(c), resident) if nbytes <= max_smem and kv_fits else 0

    fits = [c for c in range(1, top + 1) if clusters(c) > 0]
    if not fits:
        return TILED
    c = fits[0]
    while c < top and b <= clusters(c + 1):
        c += 1
    nbytes, resident = footprint(c)
    return Plan(c, share(c), nbytes, -(-clusters(c) * c // sms), resident, clusters(c))


# csrc/xslot_bwd.cu's tiled route: rows of a product's CTA tile, inner terms
# per pipeline stage, the most pieces of a split inner dimension and the
# least inner length of a piece
_TILE_ROWS = 128
_TILE_DEPTH = 16
_MAX_SPLIT = 8
_SPLIT_DEPTH = 128
TILED_PRODUCTS = ("dots", "x", "gates", "dgates", "dw", "p", "dh", "dkv")


class TiledProduct(NamedTuple):
    """One product of the backward's tiled route: its output ``rows`` (B*S
    where the batch folds into rows), the width of its CTA tile (64 or 128
    columns) and the ``pieces`` its inner dimension splits into."""

    rows: int
    tile_cols: int
    pieces: int


class TiledPlan(NamedTuple):
    """The tiled route at one shape: its products by name (``TILED_PRODUCTS``:
    the dots, the update x, the GRU's gates gi|gh, their input gradients
    dx|dh, dW_ih|dW_hh, P, dh and dv|dk), whether the row passes ride in the
    products' epilogues (``fused``: N <= the tile's width), the scratch in
    floats and whether the residuals are bf16."""

    products: Dict[str, TiledProduct]
    fused: bool
    scratch_floats: int
    bf16: bool = False

    def launches(self, iters: int) -> int:
        """The launches ``tiled_bwd`` makes in one call of ``iters``
        iterations: per iteration dots, attn, x, P, dD, dh and dv|dk (and
        two row passes where the epilogues cannot take them); per GRU gi|gh,
        its backward, dx|dh and dW; the closing sums; a memset of the
        partials where no GRU runs; with bf16 residuals the pass that
        converts them to float32 first. ``chip_smoke.py`` holds it to the
        count torch.profiler makes of one call on the card."""
        return (iters * (7 if self.fused else 9) + 4 * (iters - 1) + 1 + int(iters == 1)
                + int(self.bf16))


class SplitFwdPlan(NamedTuple):
    """The forward's tiled route at one shape (``csrc/xslot_fwd_tiled.cu``):
    one cluster of ``slot_groups`` x ``position_groups`` CTAs a batch element,
    CTA (gs, gn) owning slot group gs and position share gn, which it walks
    in tiles of ``tile`` positions (its share of k and v resident in shared
    memory, or ``streamed`` through a ring of two tiles); ``spill``: the slot
    buffers in device scratch (``scratch_floats``), past what shared memory
    holds; ``smem_bytes`` a CTA and ``clusters`` the card holds at once.
    With ``grid`` the element's CTAs (slot groups only) form no cluster: one
    cooperative launch holds every element's at once, and they exchange the
    groups' totals through the scratch and a grid barrier (``clusters`` is
    then the batch)."""

    slot_groups: int
    position_groups: int
    tile: int
    streamed: bool
    spill: bool
    smem_bytes: int
    clusters: int
    scratch_floats: int
    grid: bool = False

    @property
    def cluster(self) -> int:
        return self.slot_groups * self.position_groups

    def launches(self, iters: int) -> int:
        """One kernel a call, whatever ``iters``: it writes hist's first row
        itself and converts bf16 inputs on load. ``chip_smoke.py`` holds it
        to the count of one call on the card."""
        return 1



def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _plan_product(rows, cols, inner, batch, groups, split, sms) -> TiledProduct:
    """``plan_product`` of csrc/xslot_bwd.cu: the tile width that pads fewer
    columns (128 on a tie) and, for a ``split`` product whose tiles leave
    some of the CTAs ``sms`` SMs hold at once idle (two a SM at 64 columns,
    one at 128), as many pieces of the inner dimension as those CTAs take in
    one wave, at most ``_MAX_SPLIT``, each at least ``_SPLIT_DEPTH`` long."""
    bn = 128 if _cdiv(cols, 128) * 128 <= _cdiv(cols, 64) * 64 else 64
    tiles = _cdiv(rows, _TILE_ROWS) * _cdiv(cols, bn) * batch * groups
    resident = sms * (1 if bn == 128 else 2)
    pieces = 1
    if split and tiles < resident:
        pieces = max(1, min(_MAX_SPLIT, inner // _SPLIT_DEPTH, resident // tiles))
    chunk = _cdiv(_cdiv(inner, pieces), _TILE_DEPTH) * _TILE_DEPTH
    return TiledProduct(rows, bn, _cdiv(inner, chunk))


def tiled_plan(b: int, n: int, s: int, d: int, sms: int, bf16: bool = False) -> TiledPlan:
    """The backward's tiled route at (B, N, S, d) on a card of ``sms`` SMs, as
    ``tiled_plan`` of csrc/xslot_bwd.cu has it, for f32 or bf16 residuals;
    ``chip_smoke.py`` holds this copy to the library's ``xslot_tiled_plan``
    and scratch size."""
    bs = b * s
    shapes = dict(dots=(s, n, d, b, 1, False), x=(s, d, n, b, 1, False),
                  gates=(bs, 3 * d, d, 1, 2, False), dgates=(bs, d, 3 * d, 1, 2, False),
                  dw=(3 * d, d, s, b, 2, True), p=(s, n, d, b, 1, False),
                  dh=(s, d, n, b, 1, False), dkv=(n, d, s, b, 2, True))
    products = {name: _plan_product(*shape, sms) for name, shape in shapes.items()}
    fused = n <= products["dots"].tile_cols
    kv = products["dkv"].pieces
    # the (piece, element) dW and db partials; g, dh, x, dx (B, S, d); gi, gh
    # (B, S, 3d); dots, attn, P (B, S, N); rs, rg, q (B, S); dv's and dk's
    # pieces (split, or rounded to bf16 by the closing sums); with bf16
    # residuals their f32 copies, from the next multiple of 4 floats
    scratch = (products["dw"].pieces * b * (6 * d * d + 6 * d) + bs * (10 * d + 3 * n + 3)
               + (2 * kv * b * n * d if kv > 1 or bf16 else 0)
               + (2 * b * n * d + 6 * d * d + 6 * d + 3 if bf16 else 0))
    return TiledPlan(products, fused, scratch, bf16)


def _up4(x: int) -> int:
    return -(-x // 4) * 4


# csrc/xslot_fwd_tiled.cu: the most CTAs of its cluster (non-portable past
# 8), the tiles of positions the plan tries, largest first (at least 16
# where k and v are resident, at most 32 a ring stage where they stream),
# and its threads a CTA
_MAX_SPLIT_CLUSTER = 16
_TILES = (64, 32, 16, 8, 4, 2, 1)
_SPLIT_THREADS = 512


def _split_region_floats(s: int, d: int, cs: int, cn: int) -> int:
    # slots, the update's partial sums, the summed update (the partial sums
    # themselves where cn == 1), the next slots and the slots transposed,
    # each (slp, d + 4)
    return (5 if cn > 1 else 4) * _up4(_cdiv(s, cs)) * (d + 4)


def _split_smem_bytes(n: int, s: int, d: int, cs: int, cn: int, tile: int, streamed: bool,
                      spill: bool) -> int:
    """One CTA's dynamic shared memory as ``smem_floats`` of
    csrc/xslot_fwd_tiled.cu lays it out: the row sums of two iterations (f64)
    and this one's, the block sum's scratch, the group's total of two
    iterations, k's column sums (by stripe, then summed; f64), the GRU's
    biases, the slot buffers unless they spill, k transposed and v (the CTA's share, or a
    ring of two tiles each), the dots of a tile (rows of slp + 4) and two
    chunks of the GRU's weight rows (8 columns, fewer where d is large). The
    card's plan takes the library's ``xslot_fwd_tiled_smem_bytes``;
    ``chip_smoke.py`` holds this copy to it."""
    slp = _up4(_cdiv(s, cs))
    share = _cdiv(n, cn)
    kcols = _up4(tile if streamed else share)
    positions = ((2 if streamed else 1) * d * kcols + (2 * tile if streamed else share) * (d + 4)
                 + tile * (slp + 4))
    chunk = min(8, max(1, 3264 // (6 * (d + 4))))  # the GRU's staged weight columns
    floats = (5 * slp + 2 * (_SPLIT_THREADS // 32) + 4 + 2 * max(_SPLIT_THREADS, d) + 8 * d
              + (0 if spill else _split_region_floats(s, d, cs, cn)) + positions
              + 12 * chunk * (d + 4))
    return 4 * floats


def _split_scratch_floats(b: int, s: int, d: int, cs: int, cn: int, spill: bool,
                          grid: bool = False) -> int:
    if grid:
        return 4 * b * cs * cn  # each CTA's group total of two iterations, f64
    return b * cs * cn * _split_region_floats(s, d, cs, cn) if spill else 0


def split_fwd_plan(b: int, n: int, s: int, d: int, max_smem: int, sms: int, smem,
                   active, ctas=None) -> SplitFwdPlan:
    """The tiled forward's plan at (B, N, S, d) on a card with ``max_smem``
    bytes of opt-in shared memory a CTA and ``sms`` SMs. ``smem(cs, cn, tile,
    streamed, spill)`` is one CTA's shared memory, ``active(cs, cn, tile,
    streamed, spill)`` how many such clusters the card holds at once
    (cudaOccupancyMaxActiveClusters) and ``ctas(cs, cn, tile, streamed,
    spill)`` how many such CTAs it holds at once outside clusters. Every split
    of at most 16 CTAs (cs <= S, cn <= N) is tried in its cheapest mode that
    fits, with the largest tile that fits: k and v resident, else through a
    ring, and only where no split holds its slot buffers, those in scratch.
    The first mode that some split fits decides; among its splits the plan
    takes the least ``ceil(B / clusters) x CTAs an SM x (1/c + 1/16)``: the
    busiest SM's share of the elements' work, waves counted, with a
    sixteenth of an element's for what each CTA does whatever c (the GRU's
    rows, the sums across the cluster); then the smaller cluster, then fewer
    slot groups. Where that takes more than one wave of clusters (the card
    places a cluster within one GPC, so clusters of 10 to 16 CTAs fit only 7
    at once on an H100) and ``ctas`` is given, a grid of slot groups (cn = 1,
    no cluster, every element's CTAs at once) with a lesser cost, its one
    wave counted the same way, takes its place."""
    from fractions import Fraction

    def fit(cs, cn, resident, spill):  # the largest tile that fits, and its bytes
        share = _cdiv(n, cn)
        tiles = (sorted({min(share, t) for t in _TILES[:3]}, reverse=True) if resident
                 else [t for t in _TILES[1:] if t < share])
        for tile in tiles:
            nbytes = smem(cs, cn, tile, not resident, spill)
            if nbytes <= max_smem:
                return tile, nbytes
        return None

    for spill in (False, True):
        for resident in (True, False):
            best = None
            for cs in range(1, min(_MAX_SPLIT_CLUSTER, s) + 1):
                for cn in range(1, min(_MAX_SPLIT_CLUSTER // cs, n) + 1):
                    fits = fit(cs, cn, resident, spill)
                    if fits is None:
                        continue
                    clusters = active(cs, cn, fits[0], not resident, spill)
                    if clusters <= 0:
                        continue
                    c = cs * cn
                    per_sm = _cdiv(min(b, clusters) * c, sms)
                    key = (Fraction(_cdiv(b, clusters) * per_sm * (16 + c), 16 * c), c, cs)
                    if best is None or key < best[0]:
                        best = (key, SplitFwdPlan(cs, cn, fits[0], not resident, spill, fits[1],
                                                  clusters, 0))
            if best is not None:
                if ctas is not None and _cdiv(b, best[1].clusters) > 1:
                    best = min([best] + _grid_plans(b, s, sms, fit, ctas), key=lambda kp: kp[0])
                plan = best[1]
                return plan._replace(scratch_floats=_split_scratch_floats(
                    b, s, d, plan.slot_groups, plan.position_groups, plan.spill, plan.grid))
    raise ValueError(f"xslot forward: no cluster of up to {_MAX_SPLIT_CLUSTER} CTAs holds an "
                     f"element at B={b} N={n} S={s} d={d}")


def _grid_plans(b, s, sms, fit, ctas):
    """split_fwd_plan's grid candidates: cs slot groups an element (cn = 1),
    the slot buffers in shared memory and k and v resident where they fit,
    every element's CTAs at once; each with its cost key."""
    from fractions import Fraction

    out = []
    for cs in range(2, min(_MAX_SPLIT_CLUSTER, s) + 1):
        for resident in (True, False):
            fits = fit(cs, 1, resident, False)
            if fits is None:
                continue
            if b * cs <= ctas(cs, 1, fits[0], not resident, False):
                per_sm = _cdiv(b * cs, sms)
                key = (Fraction(per_sm * (16 + cs), 16 * cs), cs, cs)
                out.append((key, SplitFwdPlan(cs, 1, fits[0], not resident, False, fits[1], b,
                                              0, True)))
            break
    return out


_FWD_SIGNATURE = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                  + [ctypes.c_float] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
_BWD_SIGNATURE = ([ctypes.c_void_p] * 17 + [ctypes.c_int] * 5
                  + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
_FWD_TILED_SIGNATURE = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 5
                        + [ctypes.c_float] * 2 + [ctypes.c_int] * 7 + [ctypes.c_void_p])


def _library(name: str):
    from .cuda_build import load

    lib = load(name)
    fn = getattr(lib, name)
    if fn.argtypes is None and name == "xslot_fwd_tiled":
        fn.argtypes, fn.restype = _FWD_TILED_SIGNATURE, ctypes.c_int
        lib.xslot_fwd_tiled_smem_bytes.argtypes = [ctypes.c_int] * 8
        lib.xslot_fwd_tiled_smem_bytes.restype = ctypes.c_size_t
        lib.xslot_fwd_tiled_scratch_floats.argtypes = [ctypes.c_int] * 7
        lib.xslot_fwd_tiled_scratch_floats.restype = ctypes.c_size_t
        for count in (lib.xslot_fwd_tiled_max_clusters, lib.xslot_fwd_tiled_max_ctas):
            count.argtypes, count.restype = [ctypes.c_int] * 9, ctypes.c_int
    elif fn.argtypes is None:
        fn.argtypes = _FWD_SIGNATURE if name == "xslot_fwd" else _BWD_SIGNATURE
        fn.restype = ctypes.c_int
        smem = getattr(lib, f"{name}_smem_bytes")
        smem.argtypes = [ctypes.c_int] * (4 if name == "xslot_fwd" else 3)
        smem.restype = ctypes.c_size_t
        clusters = getattr(lib, f"{name}_max_clusters")
        clusters.argtypes = [ctypes.c_int] * (6 if name == "xslot_fwd" else 5)
        clusters.restype = ctypes.c_int
        if name == "xslot_bwd":
            lib.xslot_bwd_scratch_floats.argtypes = [ctypes.c_int] * 7
            lib.xslot_bwd_scratch_floats.restype = ctypes.c_size_t
            lib.xslot_tiled_plan.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
            lib.xslot_tiled_plan.restype = ctypes.c_int
    if lib.xslot_max_smem.argtypes is None:
        lib.xslot_max_smem.argtypes = [ctypes.c_int]
        lib.xslot_max_smem.restype = ctypes.c_int
        lib.xslot_error_string.argtypes = [ctypes.c_int]
        lib.xslot_error_string.restype = ctypes.c_char_p
    return lib


def _check_cuda_inputs(named, want, dtype, float32=()):
    """Every tensor of ``named`` on one CUDA device, contiguous, 16-byte
    aligned, of the shape ``want`` gives, in ``dtype`` (float32 for the
    names in ``float32``)."""
    device = next(iter(named.values())).device
    if device.type != "cuda":
        raise ValueError(f"xslot kernel runs on CUDA tensors, k is on {device}")
    for name, t in named.items():
        if t.device != device:
            raise ValueError(f"xslot kernel: {name} is on {t.device}, k on {device}")
        expected = torch.float32 if name in float32 else dtype
        if t.dtype != expected:
            raise TypeError(f"xslot kernel: {name} is {t.dtype}, expected {expected}")
        if tuple(t.shape) != want[name]:
            raise ValueError(f"xslot kernel: {name} has shape {tuple(t.shape)}, "
                             f"expected {want[name]}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"xslot kernel: {name} must be contiguous and 16-byte aligned")


def _check_dim(d):
    if d < 1:
        raise ValueError(f"xslot kernel needs a slot width d >= 1, got d={d}")


def _pad_rows(t, d4):
    """``t`` zero-padded along its last dimension to ``d4``."""
    return torch.nn.functional.pad(t, (0, d4 - t.shape[-1])).contiguous()


def _pad_gates(t, d, d4):
    """A GRU weight (3d, d) or bias (1, 3d) with each gate block r, z, n
    zero-padded to d4 rows (and a weight's columns to d4): (3 d4, d4) or
    (1, 3 d4)."""
    if t.dim() == 2 and t.shape[0] == 1:
        return _pad_rows(t.reshape(3, d), d4).reshape(1, 3 * d4)
    out = t.new_zeros((3, d4, d4))
    out[:, :d, :d] = t.reshape(3, d, d)
    return out.reshape(3 * d4, d4)


def _unpad_gates(t, d, d4):
    """The inverse of ``_pad_gates``: the true rows and columns, contiguous."""
    if t.dim() == 2 and t.shape[0] == 1:
        return t.reshape(3, d4)[:, :d].reshape(1, 3 * d)
    return t.reshape(3, d4, d4)[:, :d, :d].reshape(3 * d, d)


def pad_slot_width(k, v, initial_slots, w_ih, w_hh, b_ih, b_hh):
    """K1's inputs at a slot width d that is not a multiple of 4, zero-padded
    to the next one, as the CUDA launches take them: k, v and the slots along
    d, and each gate block of the GRU's weights and biases. Exact when the
    scale and the update's divisor keep the true d (the kernels take it as
    ``div``): the padded columns add exact zeros to the dots and the
    updates, and the GRU keeps them at zero (r = z = 1/2, n = tanh(0) = 0,
    h' = h/2 = 0)."""
    d = k.shape[-1]
    d4 = _up4(d)  # rows load four floats at a time
    return (_pad_rows(k, d4), _pad_rows(v, d4), _pad_rows(initial_slots, d4),
            _pad_gates(w_ih, d, d4), _pad_gates(w_hh, d, d4), _pad_gates(b_ih, d, d4),
            _pad_gates(b_hh, d, d4))


def launch_plan(kind: str, b: int, n: int, s: int, d: int, device, bf16: bool = False) -> Plan:
    """``_plan`` for the card that holds ``device``, with its own count of
    the clusters it holds at once for the instance of f32 or bf16 inputs
    (the shared memory is the same: both stage f32)."""
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
                   if kind == "fwd" else lib.xslot_bwd_max_clusters(n, s_cta, d, int(bf16), c))
        if got < 0:
            _raise_on(lib, -got, f"xslot {kind} occupancy query")
        return got

    return _plan(b, n, s, d, kind, lib.xslot_max_smem(dev), sms, smem, active)


def launch_tiled_plan(b: int, n: int, s: int, d: int, device, bf16: bool = False) -> TiledPlan:
    """The tiled route's plan as the C library makes it on the card that holds
    ``device`` (``xslot_tiled_plan`` and ``xslot_bwd_scratch_floats``), for
    f32 or bf16 residuals."""
    lib = _library("xslot_bwd")
    out = (ctypes.c_int * (3 * len(TILED_PRODUCTS)))()
    with torch.cuda.device(device):
        err = lib.xslot_tiled_plan(b, n, s, d, out)
        scratch = lib.xslot_bwd_scratch_floats(b, n, s, d, 1, 0, int(bf16))
    _raise_on(lib, -err, "xslot tiled plan")
    products = {name: TiledProduct(*out[3 * i:3 * i + 3])
                for i, name in enumerate(TILED_PRODUCTS)}
    return TiledPlan(products, n <= products["dots"].tile_cols, scratch, bf16)


def launch_split_fwd_plan(b: int, n: int, s: int, d: int, device,
                          bf16: bool = False) -> SplitFwdPlan:
    """``split_fwd_plan`` on the card that holds ``device``, with the C
    library's shared memory (``xslot_fwd_tiled_smem_bytes``), its counts of
    the clusters and of the CTAs the card holds at once for the f32 or bf16
    instance and its scratch size."""
    dev = device.index if device.index is not None else torch.cuda.current_device()
    return _device_split_plan(b, n, s, d, dev, bf16)


@functools.lru_cache(maxsize=256)
def _device_split_plan(b, n, s, d, dev, bf16):
    lib = _library("xslot_fwd_tiled")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def smem(cs, cn, tile, streamed, spill):
        return lib.xslot_fwd_tiled_smem_bytes(n, s, d, cs, cn, tile, int(streamed), int(spill))

    def occupancy(query):
        def count(cs, cn, tile, streamed, spill):
            with torch.cuda.device(dev):
                got = query(n, s, d, cs, cn, tile, int(streamed), int(spill), int(bf16))
            if got < 0:
                _raise_on(lib, -got, "xslot forward tiled route occupancy query")
            return got
        return count

    plan = split_fwd_plan(b, n, s, d, lib.xslot_max_smem(dev), sms, smem,
                          occupancy(lib.xslot_fwd_tiled_max_clusters),
                          occupancy(lib.xslot_fwd_tiled_max_ctas))
    return plan._replace(scratch_floats=lib.xslot_fwd_tiled_scratch_floats(
        b, s, d, plan.slot_groups, plan.position_groups, int(plan.spill), int(plan.grid)))

def _raise_on(lib, err, what):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: error {err} "
                           f"({lib.xslot_error_string(err).decode()})")


def _launch(k, v, initial_slots, w_ih, w_hh, b_ih, b_hh, iters, emit_hist):
    """Run ``csrc/xslot_fwd.cu`` (or its tiled route) on CUDA tensors: (upd,
    attn[, hist]), float32. A slot width that is not a multiple of 4 runs
    zero-padded (``pad_slot_width``), its outputs cut back to d."""
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
    if d % 4 == 0:
        return _launch_width4(k, v, initial_slots, w_ih, w_hh, b_ih, b_hh, iters, emit_hist, d)
    outs = _launch_width4(*pad_slot_width(k, v, initial_slots, w_ih, w_hh, b_ih, b_hh), iters,
                          emit_hist, d)
    return tuple(o if i == 1 else o[..., :d].contiguous() for i, o in enumerate(outs))


def _launch_width4(k, v, initial_slots, w_ih, w_hh, b_ih, b_hh, iters, emit_hist, div):
    """``_launch`` on checked inputs of a slot width that is a multiple of 4,
    ``div`` the true one (the scale and the update's divisor)."""
    b, n, d = k.shape
    s = initial_slots.shape[0]
    dtype = k.dtype
    plan = launch_plan("fwd", b, n, s, d, k.device, dtype == torch.bfloat16)
    upd = torch.empty((b, s, d), dtype=torch.float32, device=k.device)
    attn = torch.empty((b, s, n), dtype=torch.float32, device=k.device)
    hist = (torch.empty((b, iters, s, d), dtype=torch.float32, device=k.device)
            if emit_hist else None)
    outs = (upd, attn, hist) if emit_hist else (upd, attn)
    if b == 0:
        return outs
    if plan.tiled:
        _launch_tiled(k, v, initial_slots, w_ih, w_hh, b_ih, b_hh, iters, outs, div)
    else:
        lib = _library("xslot_fwd")
        with torch.cuda.device(k.device):
            stream = torch.cuda.current_stream(k.device).cuda_stream
            err = lib.xslot_fwd(k.data_ptr(), v.data_ptr(), initial_slots.data_ptr(),
                                w_ih.data_ptr(), w_hh.data_ptr(), b_ih.data_ptr(),
                                b_hh.data_ptr(), upd.data_ptr(), attn.data_ptr(),
                                hist.data_ptr() if emit_hist else None,
                                b, n, s, d, iters, float(div) ** -0.5, float(div),
                                int(dtype == torch.bfloat16), plan.cluster, int(plan.resident),
                                stream)
        _raise_on(lib, err, "xslot forward kernel")
    xslot_iterations_fused.launches += 1
    if emit_hist:
        xslot_iterations_fused.hist_launches += 1
    return outs


def _launch_tiled(k, v, initial_slots, w_ih, w_hh, b_ih, b_hh, iters, outs, div):
    """Run ``csrc/xslot_fwd_tiled.cu`` into ``outs`` (upd, attn[, hist]) on
    checked CUDA tensors, one launch: the forward where no cluster of 8 holds
    an element."""
    b, n, d = k.shape
    s = initial_slots.shape[0]
    hist = outs[2] if len(outs) == 3 else None
    bf16 = k.dtype == torch.bfloat16
    plan = launch_split_fwd_plan(b, n, s, d, k.device, bf16)
    lib = _library("xslot_fwd_tiled")
    with torch.cuda.device(k.device):
        scratch = (torch.empty(plan.scratch_floats, dtype=torch.float32, device=k.device)
                   if plan.scratch_floats else None)
        stream = torch.cuda.current_stream(k.device).cuda_stream
        err = lib.xslot_fwd_tiled(*(t.data_ptr() for t in (k, v, initial_slots, w_ih, w_hh,
                                                            b_ih, b_hh, outs[0], outs[1])),
                                  hist.data_ptr() if hist is not None else None,
                                  scratch.data_ptr() if scratch is not None else None,
                                  b, n, s, d, iters, float(div) ** -0.5, float(div), int(bf16),
                                  plan.slot_groups, plan.position_groups, plan.tile,
                                  int(plan.streamed), int(plan.spill), int(plan.grid), stream)
    _raise_on(lib, err, "xslot forward tiled route")
    xslot_iterations_fused.fwd_tiled_launches += 1

def _launch_bwd(k, v, w_ih, w_hh, b_ih, b_hh, hist, du, dattn):
    """Run ``csrc/xslot_bwd.cu`` on CUDA tensors: the gradient kernel, then
    the fixed-order sum of its partials (one a CTA and GRU iteration) over the
    batch, or the tiled route. The residuals (k, v, the GRU weights and
    biases) are all float32 or all bfloat16, hist and the cotangents float32.
    Returns what ``xslot_bwd_ref`` returns, in the residuals' dtype."""
    b, n, d = k.shape
    iters, s = hist.shape[1], hist.shape[2]
    residuals = dict(k=k, v=v, w_ih=w_ih, w_hh=w_hh, b_ih=b_ih, b_hh=b_hh)
    dtype = _input_dtype(residuals.values())
    want = {"k": (b, n, d), "v": (b, n, d), "w_ih": (3 * d, d), "w_hh": (3 * d, d),
            "b_ih": (1, 3 * d), "b_hh": (1, 3 * d), "hist": (b, iters, s, d), "du": (b, s, d),
            "dattn": (b, s, n)}
    _check_cuda_inputs(dict(residuals, hist=hist, du=du, dattn=dattn), want, dtype,
                       float32=("hist", "du", "dattn"))
    _check_dim(d)
    if d % 4 == 0:
        return _launch_bwd_width4(k, v, w_ih, w_hh, b_ih, b_hh, hist, du, dattn, d)
    d4 = _up4(d)  # rows load four floats at a time
    dk, dv, d_init, dwi, dwh, dbi, dbh = _launch_bwd_width4(
        _pad_rows(k, d4), _pad_rows(v, d4), *(_pad_gates(t, d, d4) for t in (w_ih, w_hh, b_ih, b_hh)),
        _pad_rows(hist, d4), _pad_rows(du, d4), dattn, d)
    return (dk[..., :d].contiguous(), dv[..., :d].contiguous(), d_init[:, :d].contiguous(),
            *(_unpad_gates(g, d, d4) for g in (dwi, dwh, dbi, dbh)))


def _launch_bwd_width4(k, v, w_ih, w_hh, b_ih, b_hh, hist, du, dattn, div):
    """``_launch_bwd`` on checked inputs of a slot width that is a multiple of
    4, ``div`` the true one (the scale and the update's divisor)."""
    b, n, d = k.shape
    iters, s = hist.shape[1], hist.shape[2]
    bf16 = k.dtype == torch.bfloat16
    plan = launch_plan("bwd", b, n, s, d, k.device, bf16)
    grads = (torch.empty_like(k), torch.empty_like(v),
             torch.empty((s, d), dtype=k.dtype, device=k.device), torch.empty_like(w_ih),
             torch.empty_like(w_hh), torch.empty_like(b_ih), torch.empty_like(b_hh))
    if b == 0:
        return tuple(g.zero_() for g in grads)
    lib = _library("xslot_bwd")
    with torch.cuda.device(k.device):
        scratch = torch.empty(
            lib.xslot_bwd_scratch_floats(b, n, s, d, iters, plan.cluster, int(bf16)),
            dtype=torch.float32, device=k.device)
        stream = torch.cuda.current_stream(k.device).cuda_stream
        err = lib.xslot_bwd(*(t.data_ptr() for t in (k, v, w_ih, w_hh, b_ih, b_hh, hist, du,
                                                     dattn)),
                            *(g.data_ptr() for g in grads), scratch.data_ptr(),
                            b, n, s, d, iters, float(div) ** -0.5, float(div), int(bf16),
                            plan.cluster, stream)
    _raise_on(lib, err, "xslot backward kernel")
    fused = xslot_iterations_fused
    if plan.tiled:
        fused.bwd_tiled_launches += 1
        fused.bwd_tiled_bf16_launches += int(bf16)
    else:
        fused.bwd_launches += 1
        fused.bwd_bf16_launches += int(bf16)
    return grads


# The launches as custom ops: CUDA launches the kernel, the CPU runs the plain
# version, and the fake implementation gives shapes and dtypes for tracing.
_Tensors2 = Tuple[torch.Tensor, torch.Tensor]
_Tensors3 = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
_Tensors7 = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                  torch.Tensor, torch.Tensor]


@torch.library.custom_op("scouter_tpu_torch::xslot_fwd", mutates_args=(), device_types="cuda")
def _fwd_op(k: torch.Tensor, v: torch.Tensor, initial_slots: torch.Tensor, w_ih: torch.Tensor,
            w_hh: torch.Tensor, b_ih: torch.Tensor, b_hh: torch.Tensor, iters: int) -> _Tensors2:
    """K1's forward without hist: (upd, attn), float32."""
    return _launch(k, v, initial_slots, w_ih, w_hh, b_ih, b_hh, iters, emit_hist=False)


@_fwd_op.register_kernel("cpu")
def _(k, v, initial_slots, w_ih, w_hh, b_ih, b_hh, iters):
    return xslot_fwd_ref(k, v, initial_slots, w_ih, w_hh, b_ih, b_hh, iters=iters)


@_fwd_op.register_fake
def _(k, v, initial_slots, w_ih, w_hh, b_ih, b_hh, iters):
    b, n, d = k.shape
    s = initial_slots.shape[0]
    return (k.new_empty((b, s, d), dtype=torch.float32),
            k.new_empty((b, s, n), dtype=torch.float32))


@torch.library.custom_op("scouter_tpu_torch::xslot_fwd_hist", mutates_args=(),
                         device_types="cuda")
def _fwd_hist_op(k: torch.Tensor, v: torch.Tensor, initial_slots: torch.Tensor,
                 w_ih: torch.Tensor, w_hh: torch.Tensor, b_ih: torch.Tensor, b_hh: torch.Tensor,
                 iters: int) -> _Tensors3:
    """K1's forward with hist: (upd, attn, hist (B, iters, S, d)), float32."""
    return _launch(k, v, initial_slots, w_ih, w_hh, b_ih, b_hh, iters, emit_hist=True)


@_fwd_hist_op.register_kernel("cpu")
def _(k, v, initial_slots, w_ih, w_hh, b_ih, b_hh, iters):
    return xslot_fwd_ref(k, v, initial_slots, w_ih, w_hh, b_ih, b_hh, iters=iters,
                         emit_hist=True)


@_fwd_hist_op.register_fake
def _(k, v, initial_slots, w_ih, w_hh, b_ih, b_hh, iters):
    b, n, d = k.shape
    s = initial_slots.shape[0]
    return (k.new_empty((b, s, d), dtype=torch.float32),
            k.new_empty((b, s, n), dtype=torch.float32),
            k.new_empty((b, iters, s, d), dtype=torch.float32))


@torch.library.custom_op("scouter_tpu_torch::xslot_bwd", mutates_args=(), device_types="cuda")
def _bwd_op(k: torch.Tensor, v: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor,
            b_ih: torch.Tensor, b_hh: torch.Tensor, hist: torch.Tensor, du: torch.Tensor,
            dattn: torch.Tensor) -> _Tensors7:
    """K1's backward: (dk, dv, d_initial_slots, dW_ih, dW_hh, db_ih, db_hh) in
    the residuals' dtype."""
    return _launch_bwd(k, v, w_ih, w_hh, b_ih, b_hh, hist, du, dattn)


@_bwd_op.register_kernel("cpu")
def _(k, v, w_ih, w_hh, b_ih, b_hh, hist, du, dattn):
    return xslot_bwd_ref(k, v, w_ih, w_hh, b_ih, b_hh, hist, du, dattn)


@_bwd_op.register_fake
def _(k, v, w_ih, w_hh, b_ih, b_hh, hist, du, dattn):
    s, d = hist.shape[2], hist.shape[3]
    return (torch.empty_like(k), torch.empty_like(v), k.new_empty((s, d)),
            torch.empty_like(w_ih), torch.empty_like(w_hh), torch.empty_like(b_ih),
            torch.empty_like(b_hh))


class _XSlotFused(torch.autograd.Function):
    """The xSlot loop with K1's checkpointed gradient (the ``custom_vjp`` of
    slot_pallas.py:144-211): the forward with hist, then the backward, each
    through its custom op (the kernel on CUDA tensors, the plain version on
    CPU tensors)."""

    @staticmethod
    def forward(ctx, k, v, initial_slots, w_ih, w_hh, b_ih, b_hh, iters):
        upd, attn, hist = _fwd_hist_op(k, v, initial_slots, w_ih, w_hh, b_ih, b_hh, iters)
        ctx.save_for_backward(k, v, w_ih, w_hh, b_ih, b_hh, hist)
        return upd, attn

    @staticmethod
    def backward(ctx, du, dattn):
        grads = _bwd_op(*ctx.saved_tensors, du.contiguous(), dattn.contiguous())
        return (*grads, None)


def xslot_iterations_fused(k, v, initial_slots, w_ih, w_hh, b_ih, b_hh, iters: int = 3):
    """Fused ``iters``-iteration xSlot loop.

    Args:
      k: (B, N, d) keys (to_k output); v: (B, N, d) values (raw features).
      initial_slots: (S, d); GRU weights in torch layout (3d, d), biases (1, 3d).
      All in float32, or all in bfloat16.
    Returns: (updates (B, S, d), attn (B, S, N)) from the final iteration, in
    float32.

    Under grad (grad mode on and an input requiring grad) the call goes
    through the checkpointed gradient, launching the forward kernel with hist
    and the backward kernel on CUDA tensors, which returns the gradients in
    the inputs' dtype; otherwise the forward kernel runs without hist. CPU
    tensors take the plain versions either way.

    The CUDA kernels take any d >= 1 (one that is not a multiple of 4
    zero-padded to one). The forward runs on a cluster where each of at most
    8 CTAs holds all of k and v and its share of the slots in shared memory:
    at d=64 up to N=343 at S=30 and S=1024 at N=81 (S=416 at N=196). The
    backward runs on a cluster where its share fits beside the whole of the
    GRU weights and each thread holds its part of dk and dv (N/4 * d/4 <=
    768, N rounded up): at d=64 up to N=192 at S=30 and S=192 at N=81, and
    up to d=84 at N=49. Past those, and past d=1024, each takes its tiled
    route, which any (B, N, S) the card's memory holds.
    """
    args = (k, v, initial_slots, w_ih, w_hh, b_ih, b_hh)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _XSlotFused.apply(*args, iters)
    return _fwd_op(*args, iters)


# Counts of the CUDA launches, kept where the kernels launch (a loaded export
# artifact's calls count too; the CPU path does not count): calls of the
# forward, with and without hist, on either route, of those the calls that
# emitted hist and the calls of its tiled route (each one launch),
# calls of the backward kernel on a cluster (each one gradient launch and its
# fixed-order sum) and calls of its tiled route, and of these two the calls
# with bfloat16 residuals
xslot_iterations_fused.launches = 0
xslot_iterations_fused.hist_launches = 0
xslot_iterations_fused.fwd_tiled_launches = 0
xslot_iterations_fused.bwd_launches = 0
xslot_iterations_fused.bwd_tiled_launches = 0
xslot_iterations_fused.bwd_bf16_launches = 0
xslot_iterations_fused.bwd_tiled_bf16_launches = 0
