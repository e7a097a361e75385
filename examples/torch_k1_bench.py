"""Time K1 (the fused xSlot loop) of a checkout of the port on one GPU, by
iteration, so two trees can be compared in one run on one card.

    python examples/torch_k1_bench.py [--root DIR] [--out FILE]
        [--tiled | --cluster | --stamps | --fwd-stamps]

``--root`` is the directory holding the ``scouter_tpu_torch`` package to
time (default: this checkout). For B = 1, 4, 16 and 70 at the flagship's
N=49, S=30, d=64 it times the forward (``xslot_iterations_fused`` under
no_grad) at iters = 1, 2 and 3 as the device time of one launch replayed
in a CUDA graph, and at B=70 ``torch.autograd.grad`` through the op
(forward kept; host-bound, so five runs of 50 calls after 300 warm-up
calls, all five and their median). Timers and inputs are chip_smoke.py's.
With ``--tiled`` it times instead the backward's tiled route at the CUB
recipe's (16, 81, 1000) and (64, 81, 1000) and at 448 px's (70, 196, 30)
in a CUDA graph, and splits one call's device time by kernel under
``torch.profiler``, whose events also count the call's launches and give
each launch's device time in order. With ``--cluster`` it times the
backward's cluster route alone (its gradient kernel and its fixed-order
sum, one call replayed in a CUDA graph) at B = 1, 4, 16 and 70 at N=49,
S=30, d=64, at d=48 (16, 49, 30), at (16, 81, 10) and (16, 81, 125), at
384 px's (16, 144, 30), at (16, 81, 200) and at d=96 (16, 49, 30), with
each shape's plan (cluster 0: the tiled route). With ``--stamps`` it
builds the root's ``csrc/xslot_bwd.cu`` with ``-DXSLOT_STAMPS`` (its
cluster kernel then records ``clock64()`` at the end of each phase) and
prints each phase's SM cycles (mean and max over
the CTAs) at (70, 49, 30) and (16, 49, 30), beside the stamped call's time
and the fixed-order sum's time alone. With ``--fwd-stamps`` it builds the
root's ``csrc/xslot_fwd_tiled.cu`` with ``-DXSLOT_STAMPS`` and prints, for
the forward's tiled route at (70, 784, 30), (16, 784, 30) with hist and (16,
196, 1000) with hist on each shape's plan, each phase's SM cycles (mean over
the first 160 CTAs: the loads, k's column sums, and per iteration the row
sums and total, the first tile's dots, attention and update, the other
tiles, the summed update, the GRU and the exchange) beside the unstamped
call's time in a CUDA graph. Prints one JSON line with the card's name and
power limit; ``--out`` also appends it to a file.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(HERE))
    parser.add_argument("--out", default=None)
    mode = parser.add_mutually_exclusive_group()
    mode.add_argument("--tiled", action="store_true")
    mode.add_argument("--cluster", action="store_true")
    mode.add_argument("--stamps", action="store_true")
    mode.add_argument("--fwd-stamps", action="store_true")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(HERE))
    from chip_smoke import cuda_ms, graph_ms, xslot_inputs

    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from scouter_tpu_torch.ops import cuda_build, slot_kernel

    cuda_build.build_all()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    if args.tiled:
        record = {"root": args.root, "card": card, **tiled_backward(slot_kernel)}
        return emit(record, args.out)
    if args.cluster:
        record = {"root": args.root, "card": card, **cluster_backward(slot_kernel)}
        return emit(record, args.out)
    if args.stamps:
        record = {"root": args.root, "card": card, **stamped_backward(slot_kernel)}
        return emit(record, args.out)
    if args.fwd_stamps:
        record = {"root": args.root, "card": card, **stamped_tiled_forward(slot_kernel)}
        return emit(record, args.out)
    fused = slot_kernel.xslot_iterations_fused
    n, s, d = 49, 30, 64
    record = {"root": args.root, "card": card, "forward_device_ms": {}}
    for b in (1, 4, 16, 70):
        x = xslot_inputs(b, n, s, d, "cuda")
        for iters in (1, 2, 3):
            with torch.no_grad():
                record["forward_device_ms"][f"B={b} iters={iters}"] = graph_ms(
                    lambda: fused(*x, iters), reps=50)
    leaves = [a.detach().requires_grad_() for a in xslot_inputs(70, n, s, d, "cuda")]
    upd, attn = fused(*leaves)
    cot = (2 * upd.detach(), torch.ones_like(attn))
    runs = [cuda_ms(lambda: torch.autograd.grad((upd, attn), leaves, cot, retain_graph=True),
                    50, warmup) for warmup in (300, 5, 5, 5, 5)]
    record.update(autograd_bwd_ms=statistics.median(runs), autograd_bwd_ms_runs=runs)
    return emit(record, args.out)


FWD_PHASES = ["load", "ksum"] + [f"it{i}:{phase}" for i in range(3)
                                  for phase in ("total", "dots0", "attn0", "upd0", "tiles",
                                                "x", "gru", "exchange")]


def stamped_tiled_forward(slot_kernel) -> dict:
    """The forward's tiled route built with -DXSLOT_STAMPS: each phase's SM
    cycles at each shape on its plan, beside the unstamped call's time."""
    import ctypes

    import torch

    from chip_smoke import graph_ms, xslot_inputs
    from scouter_tpu_torch.ops import cuda_build

    source = cuda_build.CSRC / "xslot_fwd_tiled.cu"
    lib_path = cuda_build.BUILD_DIR / "libxslot_fwd_tiled_stamped.so"
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-DXSLOT_STAMPS", "-o",
                    str(lib_path), str(source)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.xslot_fwd_tiled.argtypes = slot_kernel._FWD_TILED_SIGNATURE
    lib.xslot_fwd_tiled_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    per_cta, ctas = 32, 160
    raw = (ctypes.c_longlong * (ctas * per_cta))()
    out = {"stamps_source": str(source), "fwd_stamps": {}}
    for b, n, s, hist in ((70, 784, 30, False), (16, 784, 30, True), (16, 196, 1000, True)):
        d = 64
        args = xslot_inputs(b, n, s, d, "cuda")
        plan = slot_kernel.launch_split_fwd_plan(b, n, s, d, args[0].device)
        with torch.no_grad():
            ms = graph_ms(lambda: slot_kernel._launch(*args, 3, emit_hist=hist), reps=20,
                          iters=10)
        outs = [torch.empty((b, s, d), device="cuda"), torch.empty((b, s, n), device="cuda")]
        hist_t = torch.empty((b, 3, s, d), device="cuda") if hist else None
        scratch = (torch.empty(plan.scratch_floats, device="cuda") if plan.scratch_floats
                   else None)
        lib.xslot_fwd_tiled_stamps(raw, ctas * per_cta)  # zero them
        err = lib.xslot_fwd_tiled(*(t.data_ptr() for t in args + outs),
                                  hist_t.data_ptr() if hist else None,
                                  scratch.data_ptr() if scratch is not None else None,
                                  b, n, s, d, 3, float(d) ** -0.5, float(d), 0, plan.slot_groups,
                                  plan.position_groups, plan.tile, int(plan.streamed),
                                  int(plan.spill), int(plan.grid),
                                  torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        if err or lib.xslot_fwd_tiled_stamps(raw, ctas * per_cta):
            raise RuntimeError(f"the stamped tiled forward failed: error {err}")
        rows = min(ctas, b * plan.cluster)
        phases = {}
        for k, name in enumerate(FWD_PHASES, start=1):
            vals = [raw[i * per_cta + k] - raw[i * per_cta + k - 1] for i in range(rows)
                    if raw[i * per_cta + k] and raw[i * per_cta + k - 1]]
            phases[name] = statistics.mean(vals) if vals else 0.0
        out["fwd_stamps"][f"{b},{n},{s}" + (",hist" if hist else "")] = {
            "plan": [plan.slot_groups, plan.position_groups, plan.tile, plan.streamed,
                     plan.spill, plan.grid],
            "clusters": plan.clusters, "ms": ms, "cycles": phases}
    return out


def emit(record, out) -> int:
    line = json.dumps(record)
    print(line, flush=True)
    if out:
        with open(out, "a") as fh:
            fh.write(line + "\n")
    return 0


def tiled_backward(slot_kernel):
    """The backward's tiled route: device ms per call in a CUDA graph at
    each shape, and one call's device time by kernel name (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import graph_ms, xslot_inputs

    out = {"tiled_bwd_device_ms": {}, "tiled_bwd_kernels_ms": {}, "tiled_bwd_launches": {}}
    for b, n, s in ((16, 81, 1000), (64, 81, 1000), (70, 196, 30)):
        args = xslot_inputs(b, n, s, 64, "cuda")
        with torch.no_grad():
            upd, attn, hist = slot_kernel._launch(*args, 3, emit_hist=True)
            res = (args[0], args[1], args[3], args[4], args[5], args[6], hist)
            cot = (2 * upd, torch.ones_like(attn))
            key = f"B={b} N={n} S={s}"
            out["tiled_bwd_device_ms"][key] = graph_ms(
                lambda: slot_kernel._launch_bwd(*res, *cot), reps=10, iters=10)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                slot_kernel._launch_bwd(*res, *cot)
                torch.cuda.synchronize()
        out.setdefault("tiled_bwd_launch_us", {})[key] = [
            [ev.name[:48], round(ev.time_range.elapsed_us(), 2)]
            for ev in sorted(prof.events(), key=lambda e: e.time_range.start)
            if ev.device_type == torch.autograd.DeviceType.CUDA]
        kernels = {}
        for ev in prof.key_averages():
            ms = getattr(ev, "device_time_total", getattr(ev, "cuda_time_total", 0)) / 1e3
            if ms > 0:
                kernels[ev.key[:60]] = [ev.count, ms]
        out["tiled_bwd_kernels_ms"][key] = dict(
            sorted(kernels.items(), key=lambda kv: -kv[1][1]))
        out["tiled_bwd_launches"][key] = sum(count for count, _ in kernels.values())
    return out


def backward_inputs(slot_kernel, b, n, s, d):
    """The backward's residuals (the forward kernel's hist) and chip_smoke's
    cotangents (2 upd, 1) at (B, N, S, d)."""
    import torch

    from chip_smoke import xslot_inputs

    args = xslot_inputs(b, n, s, d, "cuda")
    with torch.no_grad():
        upd, attn, hist = slot_kernel._launch(*args, 3, emit_hist=True)
    return (args[0], args[1], args[3], args[4], args[5], args[6], hist), (2 * upd,
                                                                            torch.ones_like(attn))


CLUSTER_SHAPES = ((1, 49, 30, 64), (4, 49, 30, 64), (16, 49, 30, 64), (70, 49, 30, 64),
                  (16, 49, 30, 48), (16, 81, 10, 64), (16, 81, 125, 64), (16, 144, 30, 64),
                  (16, 81, 200, 64), (16, 49, 30, 96))


def cluster_backward(slot_kernel):
    """The backward's cluster route: device ms of one call (both launches)
    replayed in a CUDA graph, and its plan, at each of CLUSTER_SHAPES (a
    shape the root plans on its tiled route is timed there, its plan's
    cluster 0)."""
    import torch

    from chip_smoke import graph_ms

    out = {"cluster_bwd_device_ms": {}, "cluster_bwd_plan": {}}
    for b, n, s, d in CLUSTER_SHAPES:
        res, cot = backward_inputs(slot_kernel, b, n, s, d)
        plan = slot_kernel.launch_plan("bwd", b, n, s, d, res[0].device)
        key = f"B={b} N={n} S={s} d={d}"
        with torch.no_grad():
            out["cluster_bwd_device_ms"][key] = graph_ms(
                lambda: slot_kernel._launch_bwd(*res, *cot), reps=50)
        out["cluster_bwd_plan"][key] = [plan.cluster, plan.slots_per_cta, plan.smem_bytes,
                                        plan.resident]
    return out


STAMP_PHASES = ("hist load", "dots, row sums", "T barrier, dk", "attn", "x, GRU",
                "dx, dh", "P, G, rg", "q barrier, dv, dW", "dD, dh")


def stamped_backward(slot_kernel):
    """Builds the root's csrc/xslot_bwd.cu with -DXSLOT_STAMPS (see
    XSLOT_STAMP there: 32 slots for each of the first 160 CTAs, slot 0 at the
    start, 1 + 9 j + p at the end of phase p (STAMP_PHASES) of the j-th
    iteration walked, then the end of the d_slots0 store and of the closing
    dk/dv sum), runs its cluster route and reports each phase's SM cycles. A
    phase the iteration skips (the last iteration's GRU) counts 0."""
    import ctypes

    import torch

    from chip_smoke import graph_ms
    from scouter_tpu_torch.ops import cuda_build

    source = cuda_build.CSRC / "xslot_bwd.cu"
    lib_path = cuda_build.BUILD_DIR / "libxslot_bwd_stamped.so"
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-DXSLOT_STAMPS", "-o",
                    str(lib_path), str(source)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.xslot_bwd.argtypes = slot_kernel._BWD_SIGNATURE
    lib.xslot_bwd_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.xslot_bwd_smem_bytes.restype = ctypes.c_size_t
    lib.xslot_bwd_max_clusters.argtypes = [ctypes.c_int] * 5
    lib.xslot_bwd_scratch_floats.argtypes = [ctypes.c_int] * 7
    lib.xslot_bwd_scratch_floats.restype = ctypes.c_size_t
    lib.xslot_bwd_sum_only.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 6
    per_cta, iters = 32, 3
    count = 160 * per_cta
    slots = 3 + len(STAMP_PHASES) * iters
    dev = torch.cuda.current_device()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    raw = (ctypes.c_longlong * count)()
    out = {"stamps_source": str(source), "stamps": {}}
    for b, n, s, d in ((70, 49, 30, 64), (16, 49, 30, 64)):
        res, cot = backward_inputs(slot_kernel, b, n, s, d)
        plan = slot_kernel._plan(
            b, n, s, d, "bwd", lib.xslot_max_smem(dev), sms,
            lambda s_cta, resident: lib.xslot_bwd_smem_bytes(n, s_cta, d),
            lambda c, s_cta, resident: lib.xslot_bwd_max_clusters(n, s_cta, d, 0, c))
        grads = [torch.empty_like(t) for t in (res[0], res[1])] + [
            torch.empty((s, d), device="cuda")] + [torch.empty_like(t) for t in res[2:6]]
        scratch = torch.empty(lib.xslot_bwd_scratch_floats(b, n, s, d, iters, plan.cluster, 0),
                              device="cuda")

        def call():
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.xslot_bwd(*(t.data_ptr() for t in res + cot),
                                *(g.data_ptr() for g in grads), scratch.data_ptr(), b, n, s, d,
                                iters, float(d) ** -0.5, float(d), 0, plan.cluster, stream)
            if err:
                raise RuntimeError(f"stamped xslot_bwd failed: error {err}")

        def sums():
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.xslot_bwd_sum_only(scratch.data_ptr(), b, s, d, iters, plan.cluster,
                                         *(g.data_ptr() for g in grads[2:]), stream)
            if err:
                raise RuntimeError(f"stamped sum failed: error {err}")

        with torch.no_grad():
            ms = graph_ms(call, reps=50)
            sum_ms = graph_ms(sums, reps=50)
            torch.cuda.synchronize()
            if lib.xslot_bwd_stamps(raw, count):  # read and zero the replays' stamps
                raise RuntimeError("reading the stamps failed")
            call()
        torch.cuda.synchronize()
        if lib.xslot_bwd_stamps(raw, count):
            raise RuntimeError("reading the stamps failed")
        ctas = min(b * plan.cluster, 160)
        rows = []
        for i in range(ctas):
            row = [raw[i * per_cta + k] for k in range(slots)]
            for k in range(1, slots):  # an unwritten slot: no time since the one before
                row[k] = row[k] or row[k - 1]
            rows.append(row)
        names = ["start"] + [f"it{iters - 1 - j} {p}" for j in range(iters)
                             for p in STAMP_PHASES] + ["dk, d_slots0 store", "dk/dv cluster sum"]
        phases = {}
        for k in range(1, slots):
            deltas = [r[k] - r[k - 1] for r in rows]
            phases[names[k]] = [round(sum(deltas) / ctas, 1), max(deltas)]
        totals = [r[-1] - r[0] for r in rows]
        out["stamps"][f"B={b} N={n} S={s} d={d}"] = dict(
            plan=[plan.cluster, plan.slots_per_cta, plan.smem_bytes], stamped_call_ms=ms,
            sum_only_ms=sum_ms, cycles_mean=sum(totals) / ctas, cycles_max=max(totals),
            phases_cycles_mean_max=phases)
    clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                             "--format=csv,noheader"], capture_output=True, text=True).stdout
    out["sm_clock"] = clocks.strip()
    return out


if __name__ == "__main__":
    sys.exit(main())
