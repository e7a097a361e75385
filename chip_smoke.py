"""Drive the PyTorch/CUDA port's serving, training and explain paths on one
NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):
1. the card's name and power limit, as nvidia-smi reports them;
2. build every CUDA kernel from ``scouter_tpu_torch/csrc`` (nvcc, in parallel);
3. each kernel against its plain PyTorch version on the card at the serving
   and training shapes, with its time, the plain version's time and the
   card's bound: K1's forward (xslot_fwd) at (70, 49, 30), at the engine's
   buckets B = 1, 4, 16, at (16, 81, 10) and (16, 81, 125), at S=1000 (the
   CUB config), with bfloat16 inputs at B = 70 and 1 and at d=32, with the
   cluster plan it ran and the Python shared-memory formula held to the C
   library's, and its time at B = 1, 4, 16 and 70; its hist output; its
   backward kernel (xslot_bwd)
   against ``xslot_bwd_ref`` at the three gradient shapes and at B = 1, 4
   and 16, equal bit for bit across two calls, with its time at B = 1, 4,
   16 and 70, and the op's gradient against autograd through the plain
   version; then the backward where no cluster of 8 holds an element's
   share, on its tiled route, at the CUB recipe's (16, 81, 1000) and 448
   px's (70, 196, 30), and on a cluster at d=48 (16, 49, 30): the forward
   with hist against its plain version, the backward against
   ``xslot_bwd_ref`` and the op's gradient against autograd through the
   plain version, bit for bit across two calls, with plans, times and
   bounds;
4. serve flagship resnest26d + xSlot (f32, seeded random weights) through
   ``InferenceEngine`` (requests from several threads) and the HTTP server
   (``.npy`` bodies, one with ``?maps=1``, and ``/healthz``), counting the
   kernel launches of this phase;
5. the same weights on the card and on the CPU: logits within 1e-3;
6. serving throughput of ``make_serving_fn`` at batch 70, f32 and bf16;
7. train the flagship through ``scouter_tpu_torch.train.cli.main`` on the
   synthetic ImageNet stand-in for two epochs, then resume for a third:
   finite metrics, the reference's checkpoint names, K1's hist launches and
   its backward launches equal to the train steps, its hist-free launches
   to the val batches, and no CUDA tensor given to ``xslot_bwd_ref``;
8. explain (the reference's test.py) from that checkpoint through
   ``scouter_tpu_torch.explain.cli.main``, its launches counted over the CLI
   alone: K1 once, hist-free, for its one forward, and K2 never (as in the
   JAX package, the CLI has no K2 caller); then K2's own path, the public op
   ``render_heatmaps_fused`` on the class attention of a val batch of 70 and
   of the vis image, counted on its own: one launch per call; the 21 PNGs
   read back without Pillow and the card's overlays equal to the CPU's
   rendering of the same slot maps bit for bit; the same checkpoint and
   image on the card and on the CPU (class attention within 1e-4, uint8
   maps within 1 level); K2 against its plain version with its times and
   bound;
9. one train step at batch 4 on the card and on the CPU from the same
   weights and batch: loss and updated weights within 1e-3; then f32 train
   throughput at batch 70 on one repeated batch, whose loss must fall;
10. the CUB-200 recipe (resnest50d, 200 x 5 slots, 260 px) in bf16 through
   ``scouter_tpu_torch.train.cli.main`` for one epoch at batch 16 on the
   synthetic CUB stand-in: 16 train steps and 8 val batches, K1's counts
   zeroed just before and read just after (forward with hist 16, without
   8, the backward's tiled route 16), f32 parameters and AdamW state in the
   checkpoint, which the server's ``load_state_dict`` restores and an
   ``InferenceEngine`` answers a request from; the val loss of those weights
   in bf16 and in f32 within 0.08 x max(1, |f32 loss|)
   (tests/test_train.py:139-150); bf16 and f32 train img/s at batch 16 on
   one repeated batch, whose loss must fall, with f32 state after the steps.

The line before the last is the kernels' JSON; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
package beside this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# published peaks of one H100 SXM: f32 outside the tensor cores, HBM3
F32_PEAK_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
FLAGSHIP = dict(model="resnest26d", dataset="ImageNet", num_classes=10, channel=2048,
                use_slot=True, slots_per_class=3, hidden_dim=64, power=2, loss_status=1,
                to_k_layer=3, lambda_value=1.0, img_size=224, batch_size=70,
                pre_trained=False, seed=0)
BUCKETS = (1, 4, 16)
# the CUB-200 recipe (bench.py:105-109) in bf16 at batch 16 (bench.py:64)
CUB = dict(model="resnest50d", dataset="CUB200", num_classes=200, channel=2048,
           use_slot=True, slots_per_class=5, hidden_dim=64, power=2, loss_status=1,
           to_k_layer=3, lambda_value=10.0, img_size=260, batch_size=16,
           pre_trained=False, seed=0, compute_dtype="bfloat16")


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, iters: int, warmup: int = 5) -> float:
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def fmt_ms(times) -> str:
    return "[" + ", ".join(f"{t:.4f}" for t in times) + "]"


def xslot_inputs(b, n, s, d, device, seed=0):
    """bench.py:67-74 magnitudes (trained-net scale)."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    arrays = (rng.randn(b, n, d) * 0.1, rng.randn(b, n, d) * 0.1, rng.randn(s, d) * 0.02,
              rng.randn(3 * d, d) * 0.05, rng.randn(3 * d, d) * 0.05,
              rng.randn(1, 3 * d) * 0.05, rng.randn(1, 3 * d) * 0.05)
    return [torch.tensor(a, dtype=torch.float32, device=device) for a in arrays]


def xslot_bound(b, n, s, d, hist_iters=0, iters=3):
    """(bound ms, what bounds it) for one forward call: the card's f32 rate
    over the loop's FLOPs (``iters`` attention passes of two (S,N,d)
    products, ``iters`` - 1 GRUs of two (S,d)x(d,3d) products) against HBM
    over each input read once and output written once, the (B, iters, S, d)
    hist output included when it is written."""
    flops = b * (iters * 2 * (2 * s * n * d) + (iters - 1) * 2 * (2 * s * d * 3 * d))
    nbytes = 4 * (2 * b * n * d + s * d + 2 * 3 * d * d + 2 * 3 * d + b * s * d + b * s * n
                  + b * hist_iters * s * d)
    t_ops, t_bytes = flops / F32_PEAK_FLOPS, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def xslot_bwd_bound(b, n, s, d, iters=3):
    """(bound ms, what bounds it) for one backward call: per element
    ``iters`` attention recomputes (two (S,N,d) products) and backwards
    (four), ``iters`` - 1 GRU recomputes (two (S,d)x(d,3d) products) and
    backwards (four: dx, dh, dW_ih, dW_hh), 12.2 MFLOP at the flagship,
    against HBM over k, v, the GRU weights, hist, du and dattn read once and
    dk, dv and the seven parameter gradients written once."""
    flops = b * (iters * 6 * (2 * s * n * d) + (iters - 1) * 6 * (2 * s * d * 3 * d))
    nbytes = 4 * (2 * b * n * d + 2 * (3 * d * d + 3 * d) + b * iters * s * d + b * s * d
                  + b * s * n + 2 * b * n * d + 2 * (3 * d * d + 3 * d) + s * d)
    t_ops, t_bytes = flops / F32_PEAK_FLOPS, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def check_plan(kind, b, n, s, d, device, bf16=False):
    """K1's plan at (B, N, S, d) on the card, which takes each CTA's shared
    memory from the C library, with the Python formula held to it; returns
    the plan."""
    from scouter_tpu_torch.ops import slot_kernel

    plan = slot_kernel.launch_plan(kind, b, n, s, d, device, bf16)
    if plan.tiled:
        print(f"xslot_{kind} plan B={b} N={n} S={s} d={d}: tiled route (no cluster of 8 "
              "holds an element's share)", flush=True)
        return plan
    py_bytes = slot_kernel._smem_bytes(kind, n, plan.slots_per_cta, d, plan.resident)
    print(f"xslot_{kind} plan B={b} N={n} S={s} d={d}: cluster {plan.cluster}, "
          f"{plan.slots_per_cta} slots and {plan.smem_bytes} bytes of shared memory per CTA "
          f"(Python: {py_bytes}), {plan.ctas_per_sm} CTAs per SM, GRU weights "
          f"{'resident' if plan.resident else 'streamed'}, {plan.clusters} such clusters at "
          "once", flush=True)
    if py_bytes != plan.smem_bytes:
        fail(f"xslot_{kind}: Python's shared-memory formula gives {py_bytes} bytes, "
             f"the kernel's {plan.smem_bytes}")
    return plan


def phase_kernels():
    """K1's forward (xslot_fwd) against its plain version, its plans and its
    times at the engine's buckets and the throughput batch; returns its
    kernels-line entry."""
    import torch

    from scouter_tpu_torch.ops import slot_kernel

    fused, ref = slot_kernel.xslot_iterations_fused, slot_kernel.xslot_iterations_ref
    d = 64
    worst = 0.0
    plans = {}
    # bars: max abs 1e-4 (bench.py:85-86 at the flagship); the CUB config
    # S=1000 at N=81 is held to bench.py:85-86's upd < 1e-3, attn < 2e-2;
    # d=32 is a second slot width; B = 1, 4, 16 are the engine's buckets
    # (B=1 also the explain CLI's), each on its own plan
    cases = [((70, 49, 30, 64), torch.float32, 1e-4, 1e-4),
             ((1, 49, 30, 64), torch.float32, 1e-4, 1e-4),
             ((4, 49, 30, 64), torch.float32, 1e-4, 1e-4),
             ((16, 49, 30, 64), torch.float32, 1e-4, 1e-4),
             ((16, 81, 10, 64), torch.float32, 1e-4, 1e-4),
             ((16, 81, 125, 64), torch.float32, 1e-4, 1e-4),
             ((16, 81, 1000, 64), torch.float32, 1e-3, 2e-2),
             ((70, 49, 30, 64), torch.bfloat16, 1e-4, 1e-4),
             ((1, 49, 30, 64), torch.bfloat16, 1e-4, 1e-4),
             ((16, 49, 30, 32), torch.float32, 1e-4, 1e-4)]
    for (b, n, s, dd), dtype, bar_upd, bar_attn in cases:
        args = [a.to(dtype) for a in xslot_inputs(b, n, s, dd, "cuda")]
        plan = check_plan("fwd", b, n, s, dd, args[0].device, dtype == torch.bfloat16)
        check_plan("bwd", b, n, s, dd, args[0].device)
        plans[f"{b},{n},{s}" + ("" if dd == d else f",d={dd}")
              + ("" if dtype == torch.float32 else ",bf16")] = [
            plan.cluster, plan.ctas_per_sm, plan.resident]
        with torch.no_grad():
            upd, attn = fused(*args)
            upd_r, attn_r = ref(*args)  # bfloat16 inputs: the plain version upcasts
        torch.cuda.synchronize()
        e_upd = (upd - upd_r).abs().max().item()
        e_attn = (attn - attn_r).abs().max().item()
        print(f"xslot_fwd B={b} N={n} S={s} d={dd} {str(dtype)[6:]} inputs: outputs "
              f"{str(upd.dtype)[6:]}, max|d upd| {e_upd:.3e} (bar {bar_upd:g})  "
              f"max|d attn| {e_attn:.3e} (bar {bar_attn:g})", flush=True)
        if not (upd.dtype == attn.dtype == torch.float32 and e_upd < bar_upd
                and e_attn < bar_attn):
            fail(f"xslot_fwd disagrees with its plain version at B={b} N={n} S={s} {dtype}")
        if s <= 125:
            worst = max(worst, e_upd, e_attn)

    times = {}
    for b in (1, 4, 16, 70):  # the engine's buckets and the throughput batch
        args = xslot_inputs(b, 49, 30, d, "cuda")
        with torch.no_grad():
            eager = cuda_ms(lambda: fused(*args), 200)
            device_ms = graph_ms(lambda: fused(*args))
        bound_ms, bound_by = xslot_bound(b, 49, 30, d)
        print(f"xslot_fwd B={b} N=49 S=30: {device_ms:.5f} ms per launch in a CUDA graph, "
              f"{eager:.5f} ms per eager call, bound {bound_ms:.6f} ms ({bound_by})", flush=True)
        times[b] = (device_ms, eager, bound_ms)
    args = xslot_inputs(70, 49, 30, d, "cuda")
    with torch.no_grad():
        plain_ms = cuda_ms(lambda: ref(*args), 200)
    device_ms, eager, _ = times[70]
    bound_ms, bound_by = xslot_bound(70, 49, 30, d)
    print(f"xslot_fwd B=70 N=49 S=30: kernel {device_ms:.5f} ms, plain {plain_ms:.4f} ms, "
          f"bound {bound_ms:.5f} ms ({bound_by})", flush=True)
    return {"name": "xslot_fwd", "route": "cuda",
            "source": "scouter_tpu_torch/csrc/xslot_fwd.cu",
            "replaces": "scouter_tpu/ops/slot_pallas.py:107",
            "max_abs_err": worst, "ms": device_ms, "eager_ms": eager, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None, "plans": plans,
            "ms_by_batch": {str(b): t[0] for b, t in times.items()},
            "bound_ms_by_batch": {str(b): t[2] for b, t in times.items()}}


def xslot_grads(fn, args, cot):
    """Gradients of all 7 inputs of ``fn(*args) -> (upd, attn)`` for the
    output cotangents ``cot``."""
    import torch

    leaves = [a.detach().requires_grad_() for a in args]
    return torch.autograd.grad(fn(*leaves), leaves, cot)


def check_grads(label, b, n, s, names, got, want, exact):
    """chip_smoke's gradient bar: max abs difference <= 1e-4 x max(1, max
    |reference|), else at most 2x the plain f32 version's distance from the
    float64 gradient (the renorm has no epsilon)."""
    figures, missed = [], []
    for name, g, w, x in zip(names, got, want, exact):
        err, scale = (g - w).abs().max().item(), max(1.0, w.abs().max().item())
        e_kernel = (g.double() - x).abs().max().item()
        e_plain = (w.double() - x).abs().max().item()
        figures.append(f"{name} {err / scale:.2e} (f64: kernel {e_kernel:.2e}, "
                       f"plain {e_plain:.2e})")
        if err > 1e-4 * scale:
            missed.append(name)
            if not e_kernel <= 2 * e_plain:
                fail(f"{label} {name} at B={b} N={n} S={s}: max|d| {err:.3e} > 1e-4 x "
                     f"{scale:.3e}, and {e_kernel:.3e} from the float64 gradient against "
                     f"the plain f32 version's {e_plain:.3e}")
    print(f"{label} B={b} N={n} S={s}, max|d| / max(1, max|ref|) (bar 1e-4): "
          + ", ".join(figures), flush=True)
    if missed:
        print(f"{label} B={b} N={n} S={s}: bar 1e-4 missed for {', '.join(missed)}; "
              "each is within 2x the plain f32 version's distance from float64", flush=True)
    return max((g - w).abs().max().item() for g, w in zip(got, want))


def _alloc_only():
    """A torch.autograd.Function with K1's inputs and outputs whose backward
    only allocates the seven gradients: the cost of ``autograd.grad`` itself."""
    import torch

    class AllocOnly(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *args):
            ctx.save_for_backward(*args)
            return args[0] * 1, args[1] * 1

        @staticmethod
        def backward(ctx, *grads):
            return tuple(torch.empty_like(t) for t in ctx.saved_tensors)

    return AllocOnly


def phase_kernel_grad(entry):
    """K1 with hist, its backward kernel (xslot_bwd) against xslot_bwd_ref
    and the op's gradient against autograd through the plain version, the
    backward's bit-for-bit repeat and its times; adds the hist figures to
    ``entry`` and returns the backward's kernels-line entry.

    The op's gradients are those of ``sum(upd**2) + sum(attn)``, all taken
    with the one cotangent (2 upd, 1) of the float64 plain forward; the
    backward kernel gets the same cotangent and the kernel's hist."""
    import torch

    from scouter_tpu_torch.ops import slot_kernel

    fused, ref = slot_kernel.xslot_iterations_fused, slot_kernel.xslot_iterations_ref
    names = ("k", "v", "initial_slots", "w_ih", "w_hh", "b_ih", "b_hh")
    d, worst, worst_bwd = 64, entry["max_abs_err"], 0.0
    plans = {}
    for b, n, s in ((70, 49, 30), (16, 81, 10), (16, 81, 125)):
        args = xslot_inputs(b, n, s, d, "cuda")
        with torch.no_grad():
            upd, attn, hist = slot_kernel._launch(*args, 3, emit_hist=True)
            upd_r, attn_r, hist_r = slot_kernel.xslot_fwd_ref(*args, emit_hist=True)
        e_hist = (hist - hist_r).abs().max().item()
        e_out = max((upd - upd_r).abs().max().item(), (attn - attn_r).abs().max().item())
        print(f"xslot_fwd+hist B={b} N={n} S={s}: max|d hist| {e_hist:.3e}  "
              f"max|d upd, attn| {e_out:.3e}  (bar 1e-4)", flush=True)
        if not (e_hist <= 1e-4 and e_out <= 1e-4):
            fail(f"xslot_fwd with hist disagrees with xslot_fwd_ref at B={b} N={n} S={s}")
        worst = max(worst, e_hist, e_out)

        args64 = [a.double() for a in args]
        with torch.no_grad():
            upd64, attn64 = ref(*args64)
        cot64 = (2 * upd64, torch.ones_like(attn64))
        cot = tuple(t.float() for t in cot64)
        # the backward kernel on its own, against its plain version
        plan = slot_kernel.launch_plan("bwd", b, n, s, d, args[0].device)
        plans[f"{b},{n},{s}"] = [plan.cluster, plan.ctas_per_sm]
        res = (args[0], args[1], args[3], args[4], args[5], args[6], hist)
        res64 = tuple(a.double() for a in res)
        with torch.no_grad():
            got = slot_kernel._launch_bwd(*res, *cot)
            again = slot_kernel._launch_bwd(*res, *cot)
            want = slot_kernel.xslot_bwd_ref(*res, *cot)
            exact = slot_kernel.xslot_bwd_ref(*res64, *cot64)
        worst_bwd = max(worst_bwd, check_grads("xslot_bwd vs xslot_bwd_ref", b, n, s, names,
                                               got, want, exact))
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        print(f"xslot_bwd B={b} N={n} S={s} (cluster {plan.cluster}): two calls on the same "
              f"inputs {'equal bit for bit' if same else 'DIFFER'}", flush=True)
        if not same:
            fail(f"xslot_bwd is not deterministic at B={b} N={n} S={s}")
        # the op's gradient (forward kernel with hist, then the backward kernel)
        # against autograd through the plain forward
        got, want = xslot_grads(fused, args, cot), xslot_grads(ref, args, cot)
        exact = xslot_grads(ref, args64, cot64)
        check_grads("xslot grad", b, n, s, names, got, want, exact)

    b, n, s = 70, 49, 30  # the flagship's train batch
    args = xslot_inputs(b, n, s, d, "cuda")
    leaves = [a.detach().requires_grad_() for a in args]
    with torch.no_grad():
        hist_ms = cuda_ms(lambda: slot_kernel._launch(*args, 3, emit_hist=True), 200)
        _, _, hist = slot_kernel._launch(*args, 3, emit_hist=True)
    upd, attn = fused(*leaves)
    grad_out = (2 * upd.detach(), torch.ones_like(attn))
    res = (args[0], args[1], args[3], args[4], args[5], args[6], hist)
    # host-bound: after 300 warm-up calls (the first ~150 run at about twice
    # the warm cost), five runs of 50, reported by their median with all
    # five beside it, and the same through a Function whose backward only
    # allocates the seven gradients (the autograd engine's own cost here)
    bwd_runs = [cuda_ms(lambda: torch.autograd.grad((upd, attn), leaves, grad_out,
                                                    retain_graph=True), 50, warmup)
                for warmup in (300, 5, 5, 5, 5)]
    t_upd, t_attn = _alloc_only().apply(*leaves)
    t_out = (torch.ones_like(t_upd), torch.ones_like(t_attn))
    engine_runs = [cuda_ms(lambda: torch.autograd.grad((t_upd, t_attn), leaves, t_out,
                                                       retain_graph=True), 50, warmup)
                   for warmup in (300, 5, 5, 5, 5)]
    bwd_ms, engine_ms = statistics.median(bwd_runs), statistics.median(engine_runs)
    with torch.no_grad():
        kernel_ms = graph_ms(lambda: slot_kernel._launch_bwd(*res, *grad_out))
        kernel_eager_ms = cuda_ms(lambda: slot_kernel._launch_bwd(*res, *grad_out), 100)
        plain_bwd_ms = cuda_ms(lambda: slot_kernel.xslot_bwd_ref(*res, *grad_out), 50)

    def plain_fwd_bwd():
        u, a = ref(*leaves)
        torch.autograd.grad((u, a), leaves, grad_out)

    plain_ms = cuda_ms(plain_fwd_bwd, 50)
    hist_bound_ms, hist_bound_by = xslot_bound(b, n, s, d, hist_iters=3)
    bound_ms, bound_by = xslot_bwd_bound(b, n, s, d)

    # the backward at the engine's bucket sizes too, against its plain version
    times = {b: (kernel_ms, bound_ms)}
    for bb in BUCKETS:
        a = xslot_inputs(bb, n, s, d, "cuda", seed=bb)
        with torch.no_grad():
            u, _, h = slot_kernel._launch(*a, 3, emit_hist=True)
            r = (a[0], a[1], a[3], a[4], a[5], a[6], h)
            c = (2 * u, torch.ones((bb, s, n), device=u.device))
            got, want = slot_kernel._launch_bwd(*r, *c), slot_kernel.xslot_bwd_ref(*r, *c)
            exact = slot_kernel.xslot_bwd_ref(*(t.double() for t in r + c))
            worst_bwd = max(worst_bwd, check_grads("xslot_bwd vs xslot_bwd_ref", bb, n, s,
                                                   names, got, want, exact))
            plan = slot_kernel.launch_plan("bwd", bb, n, s, d, u.device)
            plans[f"{bb},{n},{s}"] = [plan.cluster, plan.ctas_per_sm]
            times[bb] = (graph_ms(lambda: slot_kernel._launch_bwd(*r, *c)),
                         xslot_bwd_bound(bb, n, s, d)[0])
        print(f"xslot_bwd B={bb} N={n} S={s} (cluster {plan.cluster}): {times[bb][0]:.5f} ms "
              f"in a CUDA graph, bound {times[bb][1]:.6f} ms", flush=True)
    print(f"xslot B={b} N={n} S={s}: fwd+hist {hist_ms:.4f} ms (bound {hist_bound_ms:.5f} ms, "
          f"{hist_bound_by}); backward kernel (two launches) {kernel_ms:.5f} ms in a CUDA "
          f"graph, {kernel_eager_ms:.5f} ms per eager call, bound {bound_ms:.5f} ms "
          f"({bound_by}); xslot_bwd_ref {plain_bwd_ms:.4f} ms; autograd.grad through "
          f"_XSlotFused {bwd_ms:.4f} ms, median of runs {fmt_ms(bwd_runs)} (through a "
          f"Function that only allocates the gradients: {engine_ms:.4f} ms, of "
          f"{fmt_ms(engine_runs)}); plain fwd + autograd bwd {plain_ms:.4f} ms", flush=True)
    entry.update(max_abs_err=worst, hist_ms=hist_ms, hist_bound_ms=hist_bound_ms,
                 hist_bound_by=hist_bound_by, plain_fwd_bwd_ms=plain_ms)
    return {"name": "xslot_bwd", "route": "cuda",
            "source": "scouter_tpu_torch/csrc/xslot_bwd.cu",
            "replaces": "scouter_tpu/ops/slot_pallas.py:168", "max_abs_err": worst_bwd,
            "ms": kernel_ms, "eager_ms": kernel_eager_ms, "plain_ms": plain_bwd_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "bwd_ms": bwd_ms, "bwd_ms_runs": bwd_runs, "autograd_engine_ms": engine_ms,
            "autograd_engine_ms_runs": engine_runs, "plans": plans,
            "ms_by_batch": {str(k): t[0] for k, t in sorted(times.items())},
            "bound_ms_by_batch": {str(k): t[1] for k, t in sorted(times.items())}}


def phase_kernel_grad_tiled():
    """K1's backward where it leaves the cluster: at the CUB recipe's (16,
    81, 1000) and 448 px's (70, 196, 30) on its tiled route, and at d=48
    (16, 49, 30) on a cluster. At each, the forward with hist against its
    plain version to bench.py:85-86's S=1000 bars, the backward against
    ``xslot_bwd_ref`` and the op's gradient against autograd through the
    plain version to chip_smoke's gradient bar, two backward calls equal bit
    for bit, its plan, time in a CUDA graph and bound. Returns the tiled
    route's kernels-line entry."""
    import torch

    from scouter_tpu_torch.ops import slot_kernel

    fused, ref = slot_kernel.xslot_iterations_fused, slot_kernel.xslot_iterations_ref
    names = ("k", "v", "initial_slots", "w_ih", "w_hh", "b_ih", "b_hh")
    worst, times, tiled = 0.0, {}, {}
    for b, n, s, d in ((16, 81, 1000, 64), (70, 196, 30, 64), (16, 49, 30, 48)):
        label = f"{b},{n},{s},d={d}"
        args = xslot_inputs(b, n, s, d, "cuda")
        check_plan("fwd", b, n, s, d, args[0].device)
        plan = check_plan("bwd", b, n, s, d, args[0].device)
        with torch.no_grad():
            upd, attn, hist = slot_kernel._launch(*args, 3, emit_hist=True)
            upd_r, attn_r, hist_r = slot_kernel.xslot_fwd_ref(*args, emit_hist=True)
        e_upd = max((upd - upd_r).abs().max().item(), (hist - hist_r).abs().max().item())
        e_attn = (attn - attn_r).abs().max().item()
        print(f"xslot_fwd+hist B={b} N={n} S={s} d={d}: max|d upd, hist| {e_upd:.3e} (bar "
              f"1e-3), max|d attn| {e_attn:.3e} (bar 2e-2)", flush=True)
        if not (e_upd < 1e-3 and e_attn < 2e-2):
            fail(f"xslot_fwd with hist disagrees with xslot_fwd_ref at {label}")
        args64 = [a.double() for a in args]
        with torch.no_grad():
            upd64, attn64 = ref(*args64)
        cot64 = (2 * upd64, torch.ones_like(attn64))
        cot = tuple(t.float() for t in cot64)
        res = (args[0], args[1], args[3], args[4], args[5], args[6], hist)
        with torch.no_grad():
            got = slot_kernel._launch_bwd(*res, *cot)
            again = slot_kernel._launch_bwd(*res, *cot)
            want = slot_kernel.xslot_bwd_ref(*res, *cot)
            exact = slot_kernel.xslot_bwd_ref(*(t.double() for t in res), *cot64)
        err = check_grads("xslot_bwd vs xslot_bwd_ref", b, n, s, names, got, want, exact)
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        route = "tiled route" if plan.tiled else f"cluster {plan.cluster}"
        print(f"xslot_bwd B={b} N={n} S={s} d={d} ({route}): two calls on the same inputs "
              f"{'equal bit for bit' if same else 'DIFFER'}", flush=True)
        if not same:
            fail(f"xslot_bwd is not deterministic at {label}")
        got, want = xslot_grads(fused, args, cot), xslot_grads(ref, args, cot)
        check_grads("xslot grad", b, n, s, names, got, want, xslot_grads(ref, args64, cot64))
        with torch.no_grad():
            ms = graph_ms(lambda: slot_kernel._launch_bwd(*res, *cot), reps=10, iters=10)
            plain_ms = cuda_ms(lambda: slot_kernel.xslot_bwd_ref(*res, *cot), 10)
        bound_ms, bound_by = xslot_bwd_bound(b, n, s, d)
        print(f"xslot_bwd B={b} N={n} S={s} d={d} ({route}): {ms:.5f} ms in a CUDA graph, "
              f"xslot_bwd_ref {plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by})",
              flush=True)
        times[label] = dict(route=route, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by)
        if plan.tiled:
            tiled[label] = times[label]
            worst = max(worst, err)
    if list(tiled) != ["16,81,1000,d=64", "70,196,30,d=64"]:
        fail(f"xslot_bwd took its tiled route at {list(tiled)}")
    cub = tiled["16,81,1000,d=64"]
    return {"name": "xslot_bwd_tiled", "route": "cuda",
            "source": "scouter_tpu_torch/csrc/xslot_bwd.cu",
            "replaces": "scouter_tpu/ops/slot_pallas.py:168", "max_abs_err": worst,
            "ms": cub["ms"], "plain_ms": cub["plain_ms"], "bound_ms": cub["bound_ms"],
            "bound_by": cub["bound_by"], "library_ms": None, "by_shape": times}


def post(url: str, body: bytes) -> dict:
    import urllib.request

    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


def phase_serve(cfg, state_dict):
    """Engine + HTTP on the card; returns the kernel launches of this phase."""
    import io
    import urllib.request

    import numpy as np

    from scouter_tpu_torch.ops import slot_kernel
    from scouter_tpu_torch.serve import InferenceEngine
    from scouter_tpu_torch.serve.server import make_server

    shape = (cfg.img_size, cfg.img_size, 3)
    rng = np.random.RandomState(1)
    images = rng.randint(0, 256, (24,) + shape, np.uint8)
    with InferenceEngine(cfg, state_dict, buckets=BUCKETS, device="cuda") as eng:
        slot_kernel.xslot_iterations_fused.launches = 0
        slot_kernel.xslot_iterations_fused.hist_launches = 0
        t0 = time.monotonic()
        futures = [None] * len(images)

        def client(idx):
            for i in idx:
                futures[i] = eng.submit(images[i])

        threads = [threading.Thread(target=client, args=(range(j, len(images), 4),))
                   for j in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        results = [f.result(timeout=300) for f in futures]
        for r in results:
            if r["logits"].shape != (cfg.num_classes,) or not np.isfinite(r["logits"]).all():
                fail(f"engine result malformed: logits {r['logits']}")
            if r["slot_maps"].shape != (cfg.num_classes, 7, 7):
                fail(f"engine slot_maps shape {r['slot_maps'].shape}")

        server = make_server(eng, cfg.img_size, 3, ("127.0.0.1", 0))
        port = server.server_address[1]
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            for i in range(4):
                buf = io.BytesIO()
                np.save(buf, images[i])
                query = "?maps=1" if i == 0 else ""
                payload = post(f"http://127.0.0.1:{port}/predict{query}", buf.getvalue())
                logits = np.asarray(payload["logits"])
                if logits.shape != (cfg.num_classes,) or not np.isfinite(logits).all():
                    fail(f"HTTP logits malformed: {payload}")
                if not np.allclose(logits, results[i]["logits"], rtol=1e-4, atol=1e-4):
                    fail("HTTP logits differ from the engine's for the same image")
                if (i == 0) != ("slot_maps_png" in payload):
                    fail("slot maps present iff ?maps=1")
                if i == 0 and len(payload["slot_maps_png"]) != cfg.num_classes:
                    fail("one slot map per class expected")
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
                health = json.loads(r.read())
        finally:
            server.shutdown()
            server.server_close()
            thread.join()
        launches = slot_kernel.xslot_iterations_fused.launches
        stats = eng.stats()
    seconds = time.monotonic() - t0
    if health["status"] != "ok" or health["stats"]["requests"] < len(images) + 4:
        fail(f"/healthz: {health}")
    print(f"serve: {len(images)} engine requests + 4 HTTP requests answered in "
          f"{seconds:.2f} s; engine stats {json.dumps(stats)}; xslot_fwd launches {launches}",
          flush=True)
    if launches == 0:
        fail("the serving path launched no xslot_fwd kernel")
    if slot_kernel.xslot_iterations_fused.hist_launches:
        fail("the serving path launched the training (hist) build of xslot_fwd")
    return launches


def phase_gpu_vs_cpu(cfg, state_dict):
    import numpy as np

    from scouter_tpu_torch.serve import make_serving_fn

    images = np.random.RandomState(2).randint(0, 256, (2, cfg.img_size, cfg.img_size, 3),
                                               np.uint8)
    gpu = make_serving_fn(cfg, state_dict, device="cuda")(images)
    cpu = make_serving_fn(cfg, state_dict, device="cpu")(images)
    lg, lc = gpu["logits"].cpu().numpy(), cpu["logits"].numpy()
    maps = np.abs(gpu["slot_maps"].cpu().numpy().astype(int) - cpu["slot_maps"].numpy()).max()
    print(f"gpu vs cpu: max|d logits| {np.abs(lg - lc).max():.3e} (bar rtol/atol 1e-3), "
          f"max|d slot_maps| {maps}", flush=True)
    if not np.allclose(lg, lc, rtol=1e-3, atol=1e-3):
        fail(f"flagship logits on the card differ from the CPU's:\n{lg}\n{lc}")


def phase_throughput(cfg, state_dict, card: str):
    import numpy as np
    import torch

    from scouter_tpu_torch.serve import make_serving_fn

    bs = cfg.batch_size
    images = torch.from_numpy(np.random.RandomState(3).randint(
        0, 256, (bs, cfg.img_size, cfg.img_size, 3), np.uint8)).cuda()
    for name, dtype in (("float32", None), ("bfloat16", torch.bfloat16)):
        fn = make_serving_fn(cfg, state_dict, compute_dtype=dtype, device="cuda")
        for _ in range(3):
            fn(images)
        torch.cuda.synchronize()
        iters = 20
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(images)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / iters
        if not torch.isfinite(out["logits"]).all():
            fail(f"non-finite logits in the {name} throughput run")
        print(f"throughput make_serving_fn bs={bs} {name}: {bs / dt:.1f} img/s "
              f"({dt * 1e3:.2f} ms/batch) on {card}", flush=True)


def run_cli(main, flags):
    """``main(flags)`` with its output echoed; returns (its result, the
    printed lines)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = main(flags)
    print(buf.getvalue(), end="", flush=True)
    return result, buf.getvalue().splitlines()


def flagship_flags(tmp: str):
    """The CLIs' flags for the flagship on the card, the synthetic stand-in
    (nothing at ``--dataset_dir``) and ``tmp`` as the output directory."""
    import os

    return ["--device", "cuda", "--dataset", "ImageNet", "--model", "resnest26d",
            "--num_classes", "10", "--channel", "2048", "--hidden_dim", "64",
            "--slots_per_class", "3", "--to_k_layer", "3", "--power", "2",
            "--loss_status", "1", "--lambda_value", "1", "--img_size", "224",
            "--batch_size", "70", "--pre_trained", "false",
            "--dataset_dir", os.path.join(tmp, "no_dataset"), "--output_dir", tmp]


def logged_metrics(lines):
    """The MetricLog lists of the last ``print_metric`` in ``lines``."""
    import ast

    keys = ("train loss:", "val loss:", "train acc:", "val acc:", "train CE loss",
            "val CE loss", "train attention loss", "val attention loss")
    found = {}
    for line in lines:
        for key in keys:
            if line.startswith(key):
                found[key] = ast.literal_eval(line[len(key):].strip())
    if set(found) != set(keys):
        fail(f"training printed no metric log; found {sorted(found)}")
    return found


def phase_train(tmp: str):
    """Flagship training through the train CLI on the card: two epochs, then a
    resume for a third; returns K1's forward and backward launches over both
    runs."""
    import math
    import os

    from scouter_tpu_torch.ops import slot_kernel
    from scouter_tpu_torch.train import cli

    fused = slot_kernel.xslot_iterations_fused
    flags = flagship_flags(tmp) + ["--lr_drop", "1"]
    train_steps, val_batches = 256 // 70, -(-128 // 70)  # the synthetic stand-in
    launches = bwd_launches = 0
    # the backward's plain version, watched for CUDA tensors: the train path
    # must reach it with none
    plain_bwd, cuda_plain_calls = slot_kernel.xslot_bwd_ref, []

    def watched_plain_bwd(*args):
        cuda_plain_calls.extend(a for a in args if a.is_cuda)
        return plain_bwd(*args)

    for run, (extra, epochs) in enumerate(((["--epochs", "2"], (0, 1)),
                                           (["--epochs", "3", "--resume", "true"], (2,)))):
        fused.launches = fused.hist_launches = fused.bwd_launches = 0
        t0 = time.monotonic()
        slot_kernel.xslot_bwd_ref = watched_plain_bwd
        try:
            _, lines = run_cli(cli.main, flags + extra)
        finally:
            slot_kernel.xslot_bwd_ref = plain_bwd
        seconds = time.monotonic() - t0
        if cuda_plain_calls:
            fail(f"train run {run}: xslot_bwd_ref got {len(cuda_plain_calls)} CUDA tensors")
        hist, plain = fused.hist_launches, fused.launches - fused.hist_launches
        launches += fused.launches
        bwd_launches += fused.bwd_launches
        metrics = logged_metrics(lines)
        values = [v for vs in metrics.values() for v in vs]
        if len(metrics["train loss:"]) != len(epochs) or not all(map(math.isfinite, values)):
            fail(f"train run {run}: logged metrics {metrics}")
        started = [int(line.split(":")[1]) for line in lines if line.startswith("start train :")]
        if started != list(epochs):
            fail(f"train run {run} trained epochs {started}, expected {list(epochs)}")
        if run == 1 and not any(line.startswith("resumed from") and line.endswith("epoch 1")
                                for line in lines):
            fail("the resumed run did not report resuming after epoch 1")
        print(f"train run {run}: epochs {started}, {len(epochs) * train_steps} train steps, "
              f"{seconds:.2f} s ({seconds / (len(epochs) * train_steps):.3f} s per train step "
              f"with data, eval and checkpoints); xslot_fwd launches with hist {hist}, "
              f"without {plain}; xslot_bwd launches {fused.bwd_launches}, xslot_bwd_ref "
              "given no CUDA tensor", flush=True)
        if hist != len(epochs) * train_steps:
            fail(f"hist launches {hist} != train steps {len(epochs) * train_steps}")
        if plain != len(epochs) * val_batches:
            fail(f"hist-free launches {plain} != val batches {len(epochs) * val_batches}")
        if fused.bwd_launches != len(epochs) * train_steps:
            fail(f"xslot_bwd launches {fused.bwd_launches} != train steps "
                 f"{len(epochs) * train_steps}")
    names = ["ImageNet_use_slot_checkpoint.pth"] + [
        f"ImageNet_use_slot_checkpoint{e:04d}.pth" for e in range(3)]
    missing = [n for n in names if not os.path.isfile(os.path.join(tmp, n))]
    if missing:
        fail(f"checkpoints missing: {missing} (have {sorted(os.listdir(tmp))})")
    print(f"train checkpoints: {', '.join(names)}", flush=True)
    return launches, bwd_launches


def cub_flags(tmp: str):
    """The train CLI's flags for the CUB-200 recipe in bf16 on the card, one
    epoch on the synthetic stand-in, ``tmp`` as the output directory. The
    CUB scan reads three metadata files before it looks for images (both
    packages raise without them); empty ones list no image, so the run
    takes the stand-in."""
    import os

    data = os.path.join(tmp, "no_dataset")
    os.makedirs(data, exist_ok=True)
    for name in ("images.txt", "image_class_labels.txt", "train_test_split.txt"):
        open(os.path.join(data, name), "w").close()
    return ["--device", "cuda", "--dataset", "CUB200", "--model", "resnest50d",
            "--num_classes", "200", "--channel", "2048", "--slots_per_class", "5",
            "--power", "2", "--loss_status", "1", "--to_k_layer", "3", "--lambda_value", "10",
            "--img_size", "260", "--compute_dtype", "bfloat16", "--batch_size", "16",
            "--epochs", "1", "--pre_trained", "false",
            "--dataset_dir", os.path.join(tmp, "no_dataset"), "--output_dir", tmp]


def check_f32_state(what, model_sd, opt_state):
    """Every floating tensor of a state dict and every AdamW moment is f32."""
    import torch

    bad = [k for k, v in model_sd.items() if v.is_floating_point() and v.dtype != torch.float32]
    moments = [v for st in opt_state.values() for k, v in st.items()
               if k in ("exp_avg", "exp_avg_sq")]
    bad += [f"AdamW moment {v.dtype}" for v in moments if v.dtype != torch.float32]
    if bad or not moments:
        fail(f"{what}: not float32: {bad[:5]}, {len(moments)} AdamW moments")
    return len(model_sd), len(moments)


def phase_cub_train(tmp: str):
    """The CUB-200 recipe in bf16 through the train CLI on the card for one
    epoch, K1's counts zeroed just before and read just after; the
    checkpoint's state in f32, restored by the server's ``load_state_dict``
    and answered from by an ``InferenceEngine``. Returns (K1's forward
    launches, its tiled backward's, the config, the checkpoint's weights)."""
    import math
    import os

    import numpy as np
    import torch

    from scouter_tpu_torch.core import ScouterConfig
    from scouter_tpu_torch.ops import slot_kernel
    from scouter_tpu_torch.serve import InferenceEngine
    from scouter_tpu_torch.serve.server import load_state_dict
    from scouter_tpu_torch.train import cli

    fused = slot_kernel.xslot_iterations_fused
    train_steps, val_batches = 256 // 16, 128 // 16  # the synthetic stand-in
    plain_bwd, cuda_plain_calls = slot_kernel.xslot_bwd_ref, []

    def watched_plain_bwd(*args):
        cuda_plain_calls.extend(a for a in args if a.is_cuda)
        return plain_bwd(*args)

    fused.launches = fused.hist_launches = fused.bwd_launches = fused.bwd_tiled_launches = 0
    t0 = time.monotonic()
    slot_kernel.xslot_bwd_ref = watched_plain_bwd
    try:
        _, lines = run_cli(cli.main, cub_flags(tmp))
    finally:
        slot_kernel.xslot_bwd_ref = plain_bwd
    torch.cuda.synchronize()
    seconds = time.monotonic() - t0
    hist, plain = fused.hist_launches, fused.launches - fused.hist_launches
    tiled, clustered = fused.bwd_tiled_launches, fused.bwd_launches
    metrics = logged_metrics(lines)
    values = [v for vs in metrics.values() for v in vs]
    print(f"CUB bf16 train: 1 epoch, {train_steps} train steps and {val_batches} val batches "
          f"in {seconds:.2f} s with data, eval and the checkpoint; xslot_fwd launches with "
          f"hist {hist}, without {plain}; xslot_bwd launches on its tiled route {tiled}, on a "
          f"cluster {clustered}; xslot_bwd_ref given "
          f"{len(cuda_plain_calls)} CUDA tensors", flush=True)
    if cuda_plain_calls:
        fail("CUB train: xslot_bwd_ref got CUDA tensors")
    if len(metrics["train loss:"]) != 1 or not all(map(math.isfinite, values)):
        fail(f"CUB train: logged metrics {metrics}")
    if (hist, plain, tiled, clustered) != (train_steps, val_batches, train_steps, 0):
        fail(f"CUB train: launches hist {hist}, hist-free {plain}, tiled backward {tiled}, "
             f"clustered backward {clustered}; expected {train_steps}, {val_batches}, "
             f"{train_steps}, 0")
    path = os.path.join(tmp, "CUB200_use_slot_checkpoint.pth")
    payload = torch.load(path, map_location="cpu", weights_only=True)
    tensors, moments = check_f32_state("CUB checkpoint", payload["model"],
                                       payload["optimizer"]["state"])
    cfg = ScouterConfig(**CUB).replace(device="cuda", output_dir=tmp,
                                       dataset_dir=os.path.join(tmp, "no_dataset"))
    state_dict, source = load_state_dict(cfg)
    if source != path:
        fail(f"the server restored {source}, not {path}")
    image = np.random.RandomState(6).randint(0, 256, (260, 260, 3), np.uint8)
    with InferenceEngine(cfg, state_dict, buckets=(1,), device="cuda") as eng:
        result = eng.submit(image).result(timeout=300)
    if result["logits"].shape != (200,) or not np.isfinite(result["logits"]).all():
        fail(f"CUB engine logits malformed: {result['logits']}")
    if result["slot_maps"].shape != (200, 9, 9):
        fail(f"CUB engine slot_maps shape {result['slot_maps'].shape}")
    print(f"CUB checkpoint {os.path.basename(path)}: {tensors} model tensors and {moments} "
          "AdamW moments, all float32; restored by the server's load_state_dict and "
          "answered one request through InferenceEngine (logits (200,), slot maps "
          "(200, 9, 9))", flush=True)
    return hist + plain, tiled, cfg, state_dict


def phase_cub_dtypes(cfg, state_dict, card: str):
    """The same CUB weights on the card in bf16 and in f32: the val loss
    within 0.08 x max(1, |f32 loss|) (tests/test_train.py:139-150); then
    each dtype's train img/s at batch 16 on one repeated batch (3 warm-up
    steps, 10 timed ones ending in a synchronize), whose loss must fall, the
    state f32 after the steps."""
    import torch

    from scouter_tpu_torch.data import preprocess_batch, select_dataset
    from scouter_tpu_torch.train import Trainer

    datasets = (select_dataset(cfg, train=True), select_dataset(cfg, train=False))
    val = {}
    for name in ("bfloat16", "float32"):
        trainer = Trainer(cfg.replace(compute_dtype=name), datasets=datasets)
        trainer.model.load_state_dict(state_dict)
        val[name] = trainer.run_epoch(0, "val")["loss"]
    gap = abs(val["bfloat16"] - val["float32"])
    print(f"CUB val loss of the checkpoint's weights: bf16 {val['bfloat16']:.6f}, f32 "
          f"{val['float32']:.6f}, |d| {gap:.3e} (bar 0.08 x max(1, |f32|))", flush=True)
    if not gap <= 0.08 * max(1.0, abs(val["float32"])):
        fail("the CUB val loss in bf16 leaves the bar of the f32 one")

    bs, ds = cfg.batch_size, datasets[0]
    images = preprocess_batch(torch.from_numpy(ds.images[:bs]).cuda(), dataset=cfg.dataset,
                              img_size=cfg.img_size).permute(0, 3, 1, 2).contiguous()
    batch = {"image": images, "label": torch.from_numpy(ds.labels[:bs]).long().cuda()}
    rates = {}
    for name in ("bfloat16", "float32"):
        trainer = Trainer(cfg.replace(compute_dtype=name), datasets=datasets)
        state, step = trainer.state, trainer.train_step
        losses = []
        for _ in range(3):
            state, m = step(state, batch)
            losses.append(m["loss"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            state, m = step(state, batch)
            losses.append(m["loss"])
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / 10
        losses = torch.stack(losses).tolist()
        check_f32_state(f"CUB {name} train state", state.model.state_dict(),
                        state.optimizer.state)
        print(f"CUB {name} train loss on one repeated batch of {bs}, 13 steps: "
              f"{', '.join(f'{v:.4f}' for v in losses)}", flush=True)
        if not losses[-1] < losses[0]:
            fail(f"CUB {name}: the loss did not fall on a repeated batch: {losses}")
        rates[name] = bs / dt
        print(f"CUB train throughput {name} bs={bs}: {bs / dt:.1f} img/s "
              f"({dt * 1e3:.2f} ms/step) on {card}", flush=True)
        del trainer, state
    return val, rates


def render_bound(c, n):
    """(bound ms, what bounds it) for K2 on (C, N): HBM over each input
    float read once and each RGBA float written once, against the card's
    f32 rate over 23 operations per element (min and max; subtract, divide,
    4v; per channel two adds, a min, two clamps and the x255)."""
    t_bytes = 20 * c * n / HBM_BYTES_PER_S
    t_ops = 23 * c * n / F32_PEAK_FLOPS
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def graph_ms(fn, reps: int = 100, iters: int = 20) -> float:
    """Device time of one ``fn()``: ``reps`` calls captured in one CUDA graph,
    replayed ``iters`` times, so the host's launch cost is not in it."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cuda_ms(graph.replay, iters, warmup=2) / reps


def phase_explain(tmp: str):
    """The explain path (the reference's test.py) on the card, from the
    checkpoint phase 7 wrote: ``scouter_tpu_torch.explain.cli.main``, with
    the launches read right after it; then K2's own path, the public op on
    the class attention of one val batch of 70 and of the vis image from the
    restored model, with K2's count zeroed just before it and read just
    after. Returns those launches and what the checks after it need."""
    import os

    import torch

    from scouter_tpu_torch.core import ScouterConfig
    from scouter_tpu_torch.data import preprocess_batch, select_dataset
    from scouter_tpu_torch.explain import cli
    from scouter_tpu_torch.ops import class_attention_maps, render_kernel, slot_kernel
    from scouter_tpu_torch.train import restore_inference_state

    fused, render = slot_kernel.xslot_iterations_fused, render_kernel.render_heatmaps_fused
    cfg = ScouterConfig(**FLAGSHIP).replace(
        device="cuda", output_dir=tmp, dataset_dir=os.path.join(tmp, "no_dataset"))
    run_dir = os.path.join(tmp, "explain")
    os.makedirs(run_dir)
    fused.launches = fused.hist_launches = render.launches = 0
    t0 = time.monotonic()
    cwd = os.getcwd()
    os.chdir(run_dir)  # the CLI writes to ./sloter_vis
    try:
        path, lines = run_cli(cli.main, flagship_flags(tmp))
    finally:
        os.chdir(cwd)
    torch.cuda.synchronize()
    cli_seconds = time.monotonic() - t0
    k1, k1_hist, k2_cli = fused.launches, fused.hist_launches, render.launches
    print(f"explain: CLI {cli_seconds:.2f} s; in it xslot_fwd launches {k1} (hist {k1_hist}) "
          f"for its one forward, render_heatmaps launches {k2_cli}", flush=True)
    if k1_hist or k1 != 1:
        fail(f"explain CLI: xslot_fwd launches {k1} (hist {k1_hist}), expected 1 hist-free")
    if k2_cli:
        fail(f"explain CLI: render_heatmaps launches {k2_cli}; the CLI has no K2 caller")
    if path != os.path.join(tmp, "ImageNet_use_slot_checkpoint.pth"):
        fail(f"the explain CLI restored {path}")
    if len(lines) < 2 or int(lines[-1]) not in range(cfg.num_classes):
        fail(f"the explain CLI printed no prediction: {lines}")

    t1 = time.monotonic()
    model, _, _ = restore_inference_state(cfg, device="cuda")
    torch.cuda.synchronize()
    restore_seconds = time.monotonic() - t1
    val = select_dataset(cfg, train=False)

    def slot_attention(images_u8):
        x = preprocess_batch(torch.from_numpy(images_u8).cuda(), dataset=cfg.dataset,
                             img_size=cfg.img_size)
        with torch.no_grad():
            return model(x.permute(0, 3, 1, 2).contiguous())["attn"]

    def class_rows(attn):
        return class_attention_maps(attn, cfg.num_classes, cfg.slots_per_class).reshape(
            -1, attn.shape[-1])

    vis_image = val.images[cfg.vis_id]
    batch_attn = class_rows(slot_attention(val.images[:cfg.batch_size]))
    vis_slot_attn = slot_attention(vis_image[None])[0]
    vis_attn = class_rows(vis_slot_attn[None])

    # K2's own path: the public op, which has no other caller (as in JAX)
    render.launches = 0
    t2 = time.monotonic()
    heat = [render(batch_attn), render(vis_attn)]
    torch.cuda.synchronize()
    render_seconds = time.monotonic() - t2
    k2 = render.launches
    print(f"explain: a warm restore_inference_state on its own after the CLI "
          f"{restore_seconds:.2f} s; render_heatmaps_fused on the class attention "
          f"{tuple(batch_attn.shape)} and {tuple(vis_attn.shape)} {render_seconds * 1e3:.3f} ms, "
          f"render_heatmaps launches {k2}", flush=True)
    if k2 != 2:
        fail(f"render_heatmaps_fused: {k2} launches for 2 calls")
    for attn, out in zip((batch_attn, vis_attn), heat):
        if out.shape != attn.shape + (4,) or not bool(((out >= 0) & (out <= 255)).all()):
            fail(f"render_heatmaps_fused on {tuple(attn.shape)}: shape {tuple(out.shape)} "
                 "or values outside [0, 255]")
    return dict(cfg=cfg, vis_dir=os.path.join(run_dir, "sloter_vis"), vis_image=vis_image,
                vis_slot_attn=vis_slot_attn, batch_attn=batch_attn, vis_attn=vis_attn,
                k1=k1, k2=k2, k2_cli=k2_cli)


def phase_explain_outputs(data):
    """The CLI's 21 files, read back without Pillow; each overlay equals the
    CPU's rendering of the CLI's own slot map, bit for bit."""
    import os

    import numpy as np
    import torch

    from scouter_tpu_torch.core.png import read_png
    from scouter_tpu_torch.explain import apply_colormap_on_image
    from scouter_tpu_torch.explain._imaging import resize_bilinear_u8

    cfg, vis_dir, image = data["cfg"], data["vis_dir"], data["vis_image"]
    names = (["image.png"] + [f"slot_{i}.png" for i in range(cfg.num_classes)]
             + [f"slot_mask_{i}.png" for i in range(cfg.num_classes)])
    if sorted(os.listdir(vis_dir)) != sorted(names):
        fail(f"explain CLI files: {sorted(os.listdir(vis_dir))}")
    if not np.array_equal(read_png(os.path.join(vis_dir, "image.png")), image):
        fail("image.png differs from the vis image")
    h, w = image.shape[:2]
    for i in range(cfg.num_classes):
        slot = read_png(os.path.join(vis_dir, f"slot_{i}.png"))
        mask = read_png(os.path.join(vis_dir, f"slot_mask_{i}.png"))
        if slot.shape != (7, 7) or mask.shape != (h, w, 4):
            fail(f"slot_{i}.png {slot.shape}, slot_mask_{i}.png {mask.shape}")
        resized = resize_bilinear_u8(torch.from_numpy(slot), h, w)
        _, overlaid = apply_colormap_on_image(torch.from_numpy(image), resized)
        if not np.array_equal(overlaid.numpy(), mask):
            fail(f"slot_mask_{i}.png (rendered on the card) differs from the CPU's rendering")
    print(f"explain files: {len(names)} PNGs read back; the card's overlays equal the CPU's "
          "rendering of the same slot maps bit for bit", flush=True)


def phase_explain_gpu_vs_cpu(data):
    """The same checkpoint and image on the card and on the CPU: class
    attention within 1e-4, uint8 maps within 1 level. (That the card renders
    given maps as the CPU does, bit for bit, is phase_explain_outputs'.)"""
    import torch

    from scouter_tpu_torch.data import preprocess_batch
    from scouter_tpu_torch.explain import attention_to_maps
    from scouter_tpu_torch.ops import class_attention_maps
    from scouter_tpu_torch.train import restore_inference_state

    cfg, image = data["cfg"].replace(device="cpu"), data["vis_image"]
    model, _, _ = restore_inference_state(cfg, device="cpu")
    x = preprocess_batch(torch.from_numpy(image[None]), dataset=cfg.dataset,
                         img_size=cfg.img_size)
    with torch.no_grad():
        slot_cpu = model(x.permute(0, 3, 1, 2).contiguous())["attn"][0]
    slot_gpu = data["vis_slot_attn"]
    class_gpu = class_attention_maps(slot_gpu[None], cfg.num_classes, cfg.slots_per_class)
    class_cpu = class_attention_maps(slot_cpu[None], cfg.num_classes, cfg.slots_per_class)
    err = (class_gpu.cpu() - class_cpu).abs().max().item()
    maps_gpu = attention_to_maps(slot_gpu, cfg.num_classes, cfg.slots_per_class)
    maps_cpu = attention_to_maps(slot_cpu, cfg.num_classes, cfg.slots_per_class)
    diff = (maps_gpu.cpu().int() - maps_cpu.int()).abs()
    print(f"explain gpu vs cpu: max|d class attention| {err:.3e} (bar 1e-4); uint8 maps: "
          f"{int((diff > 0).sum())} of {diff.numel()} pixels differ, by at most "
          f"{int(diff.max())} (bar 1)", flush=True)
    if not err <= 1e-4:
        fail(f"class attention on the card differs from the CPU's by {err:.3e}")
    if int(diff.max()) > 1:
        fail("uint8 slot maps on the card differ from the CPU's by more than 1 level")


def phase_render_kernel(data):
    """K2 against its plain version on the explain path's class attention
    (700, 49) and (10, 49), on (2000, 81), a constant row and a row holding
    a NaN; bar max abs 1e-4 on the [0, 255] scale (tests/test_render_pallas.py:18),
    NaN where the plain version has NaN. Returns K2's kernels-line entry."""
    import numpy as np
    import torch

    from scouter_tpu_torch.ops import render_kernel

    fused, ref = render_kernel.render_heatmaps_fused, render_kernel.render_heatmaps_ref
    batch, vis = data["batch_attn"], data["vis_attn"]
    special = batch[:4].clone()
    special[1] = 0.3  # constant: blue
    special[2, 5] = float("nan")
    rand = torch.from_numpy(np.random.RandomState(5).rand(2000, 81).astype(np.float32) * 3).cuda()
    worst = 0.0
    for name, attn in ((f"explain batch {tuple(batch.shape)}", batch),
                       (f"vis image {tuple(vis.shape)}", vis), ("random (2000, 81)", rand),
                       ("constant row and NaN row (4, 49)", special)):
        got, want = fused(attn), ref(attn)
        torch.cuda.synchronize()
        nan_same = torch.equal(torch.isnan(got), torch.isnan(want))
        ok = ~torch.isnan(want)
        err = (got[ok] - want[ok]).abs().max().item()
        print(f"render_heatmaps {name}: max|d| {err:.3e} (bar 1e-4), NaN positions "
              f"{'equal' if nan_same else 'DIFFER'}", flush=True)
        if not (err <= 1e-4 and nan_same):
            fail(f"render_heatmaps disagrees with its plain version on {name}")
        worst = max(worst, err)
    if not torch.isnan(fused(special)[2, :, :3]).all():
        fail("render_heatmaps: a NaN did not spread over its row")

    entry = {"name": "render_heatmaps", "route": "cuda",
             "source": "scouter_tpu_torch/csrc/render_heatmaps.cu",
             "replaces": "scouter_tpu/ops/render_pallas.py:53", "launches": data["k2"],
             "explain_cli_launches": data["k2_cli"], "max_abs_err": worst, "library_ms": None}
    # the explain path's shapes, the CUB recipe's class attention (200 classes
    # at N=81) and a size where the bytes outweigh a launch
    rng = np.random.RandomState(7)
    cub, big = (torch.from_numpy(rng.rand(c, 81).astype(np.float32)).cuda()
                for c in (200, 16384))
    for key, attn in (("", batch), ("_10x49", vis), ("_200x81", cub), ("_16384x81", big)):
        c, n = attn.shape
        if key in ("_200x81", "_16384x81"):
            err = (fused(attn) - ref(attn)).abs().max().item()
            if not err <= 1e-4:
                fail(f"render_heatmaps disagrees with its plain version at ({c}, {n}): {err}")
            worst = entry["max_abs_err"] = max(worst, err)
        ms = cuda_ms(lambda: fused(attn), 200)
        plain_ms = cuda_ms(lambda: ref(attn), 200)
        device_ms = graph_ms(lambda: fused(attn))
        bound_ms, bound_by = render_bound(c, n)
        print(f"render_heatmaps C={c} N={n}: kernel {ms:.5f} ms per eager call, "
              f"{device_ms:.5f} ms per launch in a CUDA graph ({bound_ms / device_ms:.3f} of "
              f"its bound), plain {plain_ms:.5f} ms, bound {bound_ms:.6f} ms ({bound_by})",
              flush=True)
        entry.update({f"ms{key}": ms, f"device_ms{key}": device_ms, f"plain_ms{key}": plain_ms,
                      f"bound_ms{key}": bound_ms, f"bound_by{key}": bound_by})
    return entry


def phase_train_gpu_vs_cpu(cfg):
    """One flagship train step at batch 4 from the same weights and batch on
    the card and on the CPU (cuDNN deterministic, TF32 off)."""
    import numpy as np
    import torch

    from scouter_tpu_torch.models import build_slot_model
    from scouter_tpu_torch.train import create_train_state, make_train_step

    cfg4 = cfg.replace(batch_size=4)
    init = build_slot_model(cfg4, device="cpu").state_dict()
    rng = np.random.RandomState(4)
    images = torch.from_numpy(rng.randn(4, 3, cfg.img_size, cfg.img_size).astype(np.float32))
    labels = torch.from_numpy(rng.randint(0, cfg.num_classes, 4))
    names = ("slot.gru.weight_ih_l0", "conv1x1.weight", "backbone.layer4.1.bn3.running_mean",
             "backbone.layer4.1.bn3.running_var")
    results = {}
    torch.backends.cudnn.deterministic = True
    try:
        for dev in ("cuda", "cpu"):
            model = build_slot_model(cfg4, fused_slot=True, device=dev)
            model.load_state_dict(init)
            state = create_train_state(model, cfg.lr)
            _, m = make_train_step(cfg.lambda_value)(
                state, {"image": images.to(dev), "label": labels.to(dev)})
            sd = model.state_dict()
            results[dev] = (m["loss"].item(), {k: sd[k].cpu() for k in names})
    finally:
        torch.backends.cudnn.deterministic = False
    (lg, pg), (lc, pc) = results["cuda"], results["cpu"]
    errs = {k: (pg[k] - pc[k]).abs().max().item() for k in names}
    print(f"train step gpu vs cpu (batch 4): loss {lg:.6f} vs {lc:.6f}; max|d| after the "
          f"step: {json.dumps(errs)} (bar rtol/atol 1e-3)", flush=True)
    if not np.isclose(lg, lc, rtol=1e-3, atol=1e-3):
        fail(f"train-step loss on the card {lg} differs from the CPU's {lc}")
    for k in names:
        if not torch.allclose(pg[k], pc[k], rtol=1e-3, atol=1e-3):
            fail(f"{k} after one train step differs between card and CPU by {errs[k]:.3e}")


def phase_train_throughput(cfg, card: str):
    """f32 train steps on one repeated batch of 70 synthetic ImageNet images:
    3 warm-up steps, then 10 timed ones ending in a synchronize. The loss
    must fall."""
    import torch

    from scouter_tpu_torch.data import _synthetic_folder, preprocess_batch
    from scouter_tpu_torch.models import build_slot_model
    from scouter_tpu_torch.train import create_train_state, make_train_step

    bs = cfg.batch_size
    ds = _synthetic_folder(cfg.dataset, cfg.num_classes, cfg.img_size, train=True)
    images = preprocess_batch(torch.from_numpy(ds.images[:bs]).cuda(), dataset=cfg.dataset,
                              img_size=cfg.img_size).permute(0, 3, 1, 2).contiguous()
    batch = {"image": images, "label": torch.from_numpy(ds.labels[:bs]).long().cuda()}
    state = create_train_state(build_slot_model(cfg, fused_slot=True, device="cuda"), cfg.lr)
    step = make_train_step(cfg.lambda_value)
    losses = []
    for _ in range(3):
        state, m = step(state, batch)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    iters = 10
    t0 = time.perf_counter()
    for _ in range(iters):
        state, m = step(state, batch)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / iters
    losses = torch.stack(losses).tolist()
    print(f"train loss on one repeated batch of {bs}, 13 steps: "
          f"{', '.join(f'{v:.4f}' for v in losses)}", flush=True)
    if not losses[-1] < losses[0]:
        fail(f"the loss did not fall on a repeated batch: {losses[0]} -> {losses[-1]}")
    print(f"train throughput f32 bs={bs}: {bs / dt:.1f} img/s ({dt * 1e3:.2f} ms/step) "
          f"on {card}", flush=True)


def main() -> int:
    if not (ROOT / "scouter_tpu_torch" / "__init__.py").exists():
        fail(f"the scouter_tpu_torch package is not beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        fail("torch sees no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)

    from scouter_tpu_torch.core import ScouterConfig
    from scouter_tpu_torch.models import build_slot_model
    from scouter_tpu_torch.ops import cuda_build

    t0 = time.monotonic()
    cuda_build.build_all()
    print(f"built {', '.join(cuda_build.SOURCES)} in {time.monotonic() - t0:.1f} s", flush=True)

    entry = phase_kernels()
    bwd_entry = phase_kernel_grad(entry)
    tiled_entry = phase_kernel_grad_tiled()

    cfg = ScouterConfig(**FLAGSHIP)
    state_dict = build_slot_model(cfg, device="cpu").state_dict()
    entry["serve_launches"] = phase_serve(cfg, state_dict)
    phase_gpu_vs_cpu(cfg, state_dict)
    phase_throughput(cfg, state_dict, card)
    with tempfile.TemporaryDirectory() as tmp:
        entry["launches"], bwd_entry["launches"] = phase_train(tmp)
        explain = phase_explain(tmp)
        entry["explain_launches"] = explain["k1"]
        phase_explain_outputs(explain)
        phase_explain_gpu_vs_cpu(explain)
        render_entry = phase_render_kernel(explain)
    phase_train_gpu_vs_cpu(cfg)
    phase_train_throughput(cfg, card)
    with tempfile.TemporaryDirectory() as tmp:
        entry["cub_launches"], tiled_entry["launches"], cub_cfg, cub_sd = phase_cub_train(tmp)
        tiled_entry["cub_val_loss"], tiled_entry["cub_train_img_per_s"] = phase_cub_dtypes(
            cub_cfg, cub_sd, card)
    print(f"chip_smoke finished in {time.monotonic() - t0:.1f} s after the build started",
          flush=True)

    print(json.dumps({"kernels": [entry, bwd_entry, tiled_entry, render_entry]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
