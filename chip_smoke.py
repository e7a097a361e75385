"""Drive the PyTorch/CUDA port's serving and training paths on one NVIDIA
GPU and check them.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):
1. the card's name and power limit, as nvidia-smi reports them;
2. build every CUDA kernel from ``scouter_tpu_torch/csrc`` (nvcc, in parallel);
3. each kernel against its plain PyTorch version on the card at the serving
   and training shapes, with its time, the plain version's time and the
   card's bound; for K1 also its hist output and its checkpointed gradient
   against autograd through the plain version;
4. serve flagship resnest26d + xSlot (f32, seeded random weights) through
   ``InferenceEngine`` (requests from several threads) and the HTTP server
   (``.npy`` bodies, one with ``?maps=1``, and ``/healthz``), counting the
   kernel launches of this phase;
5. the same weights on the card and on the CPU: logits within 1e-3;
6. serving throughput of ``make_serving_fn`` at batch 70, f32 and bf16;
7. train the flagship through ``scouter_tpu_torch.train.cli.main`` on the
   synthetic ImageNet stand-in for two epochs, then resume for a third:
   finite metrics, the reference's checkpoint names, K1's hist launches equal
   to the train steps and its hist-free launches to the val batches;
8. one train step at batch 4 on the card and on the CPU from the same
   weights and batch: loss and updated weights within 1e-3; then f32 train
   throughput at batch 70 on one repeated batch, whose loss must fall.

The line before the last is the kernels' JSON; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
package beside this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
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


def xslot_inputs(b, n, s, d, device, seed=0):
    """bench.py:67-74 magnitudes (trained-net scale)."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    arrays = (rng.randn(b, n, d) * 0.1, rng.randn(b, n, d) * 0.1, rng.randn(s, d) * 0.02,
              rng.randn(3 * d, d) * 0.05, rng.randn(3 * d, d) * 0.05,
              rng.randn(1, 3 * d) * 0.05, rng.randn(1, 3 * d) * 0.05)
    return [torch.tensor(a, dtype=torch.float32, device=device) for a in arrays]


def xslot_bound(b, n, s, d, hist_iters=0):
    """(bound ms, what bounds it) for one call: the card's f32 rate over the
    loop's FLOPs against HBM over each input read once and output written
    once, the (B, iters, S, d) hist output included when it is written."""
    flops = b * (3 * 2 * (2 * s * n * d) + 2 * 2 * (2 * s * d * 3 * d))
    nbytes = 4 * (2 * b * n * d + s * d + 2 * 3 * d * d + 2 * 3 * d + b * s * d + b * s * n
                  + b * hist_iters * s * d)
    t_ops, t_bytes = flops / F32_PEAK_FLOPS, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def phase_kernels():
    """K1 (xslot_fwd) against its plain version; returns its kernels-line entry."""
    import torch

    from scouter_tpu_torch.ops import slot_kernel

    d = 64
    worst = 0.0
    for b, n, s in ((70, 49, 30), (16, 49, 30), (16, 81, 10), (16, 81, 125)):
        args = xslot_inputs(b, n, s, d, "cuda")
        with torch.no_grad():
            upd, attn = slot_kernel.xslot_iterations_fused(*args)
            upd_r, attn_r = slot_kernel.xslot_iterations_ref(*args)
        torch.cuda.synchronize()
        e_upd = (upd - upd_r).abs().max().item()
        e_attn = (attn - attn_r).abs().max().item()
        print(f"xslot_fwd B={b} N={n} S={s} d={d}: max|d upd| {e_upd:.3e}  "
              f"max|d attn| {e_attn:.3e}  (bar 1e-4)", flush=True)
        if not (e_upd < 1e-4 and e_attn < 1e-4):
            fail(f"xslot_fwd disagrees with its plain version at B={b} N={n} S={s}")
        worst = max(worst, e_upd, e_attn)

    b, n, s = 70, 49, 30  # the throughput batch of the flagship
    args = xslot_inputs(b, n, s, d, "cuda")
    with torch.no_grad():
        ms = cuda_ms(lambda: slot_kernel.xslot_iterations_fused(*args), 200)
        plain_ms = cuda_ms(lambda: slot_kernel.xslot_iterations_ref(*args), 200)
    bound_ms, bound_by = xslot_bound(b, n, s, d)
    print(f"xslot_fwd B={b} N={n} S={s}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {bound_ms:.5f} ms ({bound_by})", flush=True)
    return {"name": "xslot_fwd", "route": "cuda",
            "source": "scouter_tpu_torch/csrc/xslot_fwd.cu",
            "replaces": "scouter_tpu/ops/slot_pallas.py:84",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def xslot_grads(fn, args, cot):
    """Gradients of all 7 inputs of ``fn(*args) -> (upd, attn)`` for the
    output cotangents ``cot``."""
    import torch

    leaves = [a.detach().requires_grad_() for a in args]
    return torch.autograd.grad(fn(*leaves), leaves, cot)


def phase_kernel_grad(entry):
    """K1 with hist and its checkpointed gradient against the plain version
    and autograd through it; adds the hist and backward figures to ``entry``.

    The gradients are those of ``sum(upd**2) + sum(attn)``, all taken with
    the one cotangent (2 upd, 1) of the float64 plain forward. Bar: max abs
    difference from autograd through the plain version <= 1e-4 x max(1, max
    |reference gradient|). The renorm has no epsilon, so on inputs with a
    row sum near zero the plain f32 version is itself further than that from
    the float64 gradient; at such a shape the kernel's gradient is held
    instead to at most twice the plain f32 version's own distance from the
    float64 gradient, and the line says so."""
    import torch

    from scouter_tpu_torch.ops import slot_kernel

    fused, ref = slot_kernel.xslot_iterations_fused, slot_kernel.xslot_iterations_ref
    names = ("k", "v", "initial_slots", "w_ih", "w_hh", "b_ih", "b_hh")
    d, worst = 64, entry["max_abs_err"]
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
        got, want = xslot_grads(fused, args, cot), xslot_grads(ref, args, cot)
        exact = xslot_grads(ref, args64, cot64)
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
                    fail(f"K1 gradient of {name} at B={b} N={n} S={s}: max|d| {err:.3e} "
                         f"> 1e-4 x {scale:.3e}, and {e_kernel:.3e} from the float64 "
                         f"gradient against the plain f32 version's {e_plain:.3e}")
        print(f"xslot grad B={b} N={n} S={s}, max|d| / max(1, max|ref|) (bar 1e-4): "
              + ", ".join(figures), flush=True)
        if missed:
            print(f"xslot grad B={b} N={n} S={s}: bar 1e-4 missed for {', '.join(missed)}; "
                  "each is within 2x the plain f32 version's distance from float64",
                  flush=True)

    b, n, s = 70, 49, 30  # the flagship's train batch
    args = xslot_inputs(b, n, s, d, "cuda")
    leaves = [a.detach().requires_grad_() for a in args]
    with torch.no_grad():
        hist_ms = cuda_ms(lambda: slot_kernel._launch(*args, 3, emit_hist=True), 200)
        ms = cuda_ms(lambda: slot_kernel._launch(*args, 3, emit_hist=False), 200)
    upd, attn = fused(*leaves)
    grad_out = (2 * upd.detach(), torch.ones_like(attn))
    bwd_ms = cuda_ms(lambda: torch.autograd.grad((upd, attn), leaves, grad_out,
                                                 retain_graph=True), 50)

    def plain_fwd_bwd():
        u, a = ref(*leaves)
        torch.autograd.grad((u, a), leaves, grad_out)

    plain_ms = cuda_ms(plain_fwd_bwd, 50)
    hist_bound_ms, hist_bound_by = xslot_bound(b, n, s, d, hist_iters=3)
    print(f"xslot B={b} N={n} S={s}: fwd+hist {hist_ms:.4f} ms (bound {hist_bound_ms:.5f} ms, "
          f"{hist_bound_by}), fwd {ms:.4f} ms, checkpointed bwd (plain ops) {bwd_ms:.4f} ms, "
          f"plain fwd + autograd bwd {plain_ms:.4f} ms", flush=True)
    entry.update(max_abs_err=worst, hist_ms=hist_ms, hist_bound_ms=hist_bound_ms,
                 hist_bound_by=hist_bound_by, bwd_ms=bwd_ms, plain_fwd_bwd_ms=plain_ms)


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


def run_cli(flags):
    """``scouter_tpu_torch.train.cli.main(flags)`` with its output echoed;
    returns the printed lines."""
    import contextlib
    import io

    from scouter_tpu_torch.train import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(flags)
    print(buf.getvalue(), end="", flush=True)
    return buf.getvalue().splitlines()


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
    resume for a third; returns K1's launches over both runs."""
    import math
    import os

    from scouter_tpu_torch.ops import slot_kernel

    fused = slot_kernel.xslot_iterations_fused
    flags = ["--device", "cuda", "--dataset", "ImageNet", "--model", "resnest26d",
             "--num_classes", "10", "--channel", "2048", "--hidden_dim", "64",
             "--slots_per_class", "3", "--to_k_layer", "3", "--power", "2",
             "--loss_status", "1", "--lambda_value", "1", "--img_size", "224",
             "--batch_size", "70", "--lr_drop", "1", "--pre_trained", "false",
             "--dataset_dir", os.path.join(tmp, "no_dataset"), "--output_dir", tmp]
    train_steps, val_batches = 256 // 70, -(-128 // 70)  # the synthetic stand-in
    launches = 0
    for run, (extra, epochs) in enumerate(((["--epochs", "2"], (0, 1)),
                                           (["--epochs", "3", "--resume", "true"], (2,)))):
        fused.launches = fused.hist_launches = 0
        t0 = time.monotonic()
        lines = run_cli(flags + extra)
        seconds = time.monotonic() - t0
        hist, plain = fused.hist_launches, fused.launches - fused.hist_launches
        launches += fused.launches
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
              f"without {plain}", flush=True)
        if hist != len(epochs) * train_steps:
            fail(f"hist launches {hist} != train steps {len(epochs) * train_steps}")
        if plain != len(epochs) * val_batches:
            fail(f"hist-free launches {plain} != val batches {len(epochs) * val_batches}")
    names = ["ImageNet_use_slot_checkpoint.pth"] + [
        f"ImageNet_use_slot_checkpoint{e:04d}.pth" for e in range(3)]
    missing = [n for n in names if not os.path.isfile(os.path.join(tmp, n))]
    if missing:
        fail(f"checkpoints missing: {missing} (have {sorted(os.listdir(tmp))})")
    print(f"train checkpoints: {', '.join(names)}", flush=True)
    return launches


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
    phase_kernel_grad(entry)

    cfg = ScouterConfig(**FLAGSHIP)
    state_dict = build_slot_model(cfg, device="cpu").state_dict()
    entry["serve_launches"] = phase_serve(cfg, state_dict)
    phase_gpu_vs_cpu(cfg, state_dict)
    phase_throughput(cfg, state_dict, card)
    with tempfile.TemporaryDirectory() as tmp:
        entry["launches"] = phase_train(tmp)
    phase_train_gpu_vs_cpu(cfg)
    phase_train_throughput(cfg, card)
    print(f"chip_smoke finished in {time.monotonic() - t0:.1f} s after the build started",
          flush=True)

    print(json.dumps({"kernels": [entry]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
