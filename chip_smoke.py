"""Drive the PyTorch/CUDA port's serving path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):
1. the card's name and power limit, as nvidia-smi reports them;
2. build every CUDA kernel from ``scouter_tpu_torch/csrc`` (nvcc, in parallel);
3. each kernel against its plain PyTorch version on the card at the serving
   shapes, with its time, the plain version's time and the card's bound;
4. serve flagship resnest26d + xSlot (f32, seeded random weights) through
   ``InferenceEngine`` (requests from several threads) and the HTTP server
   (``.npy`` bodies, one with ``?maps=1``, and ``/healthz``), counting the
   kernel launches of this phase;
5. the same weights on the card and on the CPU: logits within 1e-3;
6. serving throughput of ``make_serving_fn`` at batch 70, f32 and bf16.

The line before the last is the kernels' JSON; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
package beside this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
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


def xslot_bound(b, n, s, d):
    """(bound ms, what bounds it) for one call: the card's f32 rate over the
    loop's FLOPs against HBM over each input read once and output written once."""
    flops = b * (3 * 2 * (2 * s * n * d) + 2 * 2 * (2 * s * d * 3 * d))
    nbytes = 4 * (2 * b * n * d + s * d + 2 * 3 * d * d + 2 * 3 * d + b * s * d + b * s * n)
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

    cfg = ScouterConfig(**FLAGSHIP)
    state_dict = build_slot_model(cfg, device="cpu").state_dict()
    entry["launches"] = phase_serve(cfg, state_dict)
    phase_gpu_vs_cpu(cfg, state_dict)
    phase_throughput(cfg, state_dict, card)

    print(json.dumps({"kernels": [entry]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
