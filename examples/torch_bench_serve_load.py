"""Concurrent clients through the port's HTTP server and serving engine.

    python examples/torch_bench_serve_load.py [--clients 16] [--requests 16]
        [--maps_frac 0.25] [--payload npy|png] [--out FILE]

Counterpart of the JAX package's ``examples/bench_serve_load.py``: the
flagship resnest26d + xSlot (seeded random weights) behind
``serve/server.py::make_server`` and ``serve/engine.py::InferenceEngine``;
N client threads post single images over localhost, each request asking
for the per-class slot maps (``?maps=1``) with probability ``--maps_frac``.
``--payload npy`` sends the raw uint8 array, ``png`` a PNG written by the
port's own encoder (``core/png.py``), which the server decodes on the card.
One JSON line: p50/p90/p99 latency of each variant, the realized img/s over
successful requests, errors, the engine's requests, batches and padded
slots, and its bucket fill (``stats()["bucket_fill"]``, "b/n": a device
batch of bucket b carrying n live requests).

Runs on the card unless given ``--device cpu``; results also go to
``--out`` (default ``build/torch_bench_serve_load.jsonl``).
"""

from __future__ import annotations

import argparse
import io
import json
import os
import sys
import threading
import time
import urllib.request

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_bench_common as common  # noqa: E402


def post(url: str, body: bytes, timeout: float = 120.0) -> dict:
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    common.add_device_arg(p)
    p.add_argument("--clients", type=int, default=16)
    p.add_argument("--requests", type=int, default=16, help="requests a client, one at a time")
    p.add_argument("--maps_frac", type=float, default=0.25)
    p.add_argument("--payload", default="npy", choices=["npy", "png"])
    p.add_argument("--model", default="resnest26d")
    p.add_argument("--num_classes", type=int, default=10)
    p.add_argument("--channel", type=int, default=2048)
    p.add_argument("--img_size", type=int, default=224)
    p.add_argument("--buckets", default="1,4,16,32")
    p.add_argument("--max_wait_ms", type=float, default=5.0)
    p.add_argument("--compute_dtype", default="bfloat16", choices=["float32", "bfloat16"])
    p.add_argument("--out", default=os.path.join(common.BUILD,
                                                 "torch_bench_serve_load.jsonl"))
    args = p.parse_args(argv)
    device, card = common.setup(args.device)

    import numpy as np
    import torch

    from scouter_tpu_torch.core.png import encode_png
    from scouter_tpu_torch.models import build_slot_model
    from scouter_tpu_torch.serve import InferenceEngine
    from scouter_tpu_torch.serve.server import make_server

    cfg = common.flagship(model=args.model, num_classes=args.num_classes, channel=args.channel,
                          img_size=args.img_size, batch_size=1)
    dtype = torch.bfloat16 if args.compute_dtype == "bfloat16" else None
    state_dict = build_slot_model(cfg, device="cpu").state_dict()
    img = np.random.RandomState(0).randint(0, 256, (cfg.img_size, cfg.img_size, 3), np.uint8)
    if args.payload == "npy":
        buf = io.BytesIO()
        np.save(buf, img)
        body = buf.getvalue()
    else:
        body = encode_png(img)

    buckets = tuple(int(b) for b in args.buckets.split(","))
    latency = {"plain": [], "maps": []}
    errors, lock = [], threading.Lock()
    with InferenceEngine(cfg, state_dict, buckets=buckets, max_wait_ms=args.max_wait_ms,
                         compute_dtype=dtype, device=device) as eng:
        for b in buckets:  # every bucket warm before traffic
            eng.infer_batch(np.zeros((b,) + img.shape, np.uint8))
        pre = eng.stats()
        server = make_server(eng, cfg.img_size, 3, ("127.0.0.1", 0))
        host, port = server.server_address[:2]
        threading.Thread(target=server.serve_forever, daemon=True).start()
        base = f"http://{host}:{port}/predict"

        def client(idx):
            rng = np.random.RandomState(idx)
            for _ in range(args.requests):
                maps = rng.rand() < args.maps_frac
                t0 = time.perf_counter()
                try:
                    out = post(base + ("?maps=1" if maps else ""), body)
                    if "pred" not in out or (maps and len(out["slot_maps_png"]) !=
                                             cfg.num_classes):
                        raise ValueError(f"malformed answer {sorted(out)}")
                    with lock:
                        latency["maps" if maps else "plain"].append(time.perf_counter() - t0)
                except Exception as exc:  # noqa: BLE001 -- counted and reported
                    with lock:
                        errors.append(f"{type(exc).__name__}: {exc}")

        threads = [threading.Thread(target=client, args=(i,)) for i in range(args.clients)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        post_stats = eng.stats()
        server.shutdown()
        server.server_close()

    done = sum(len(v) for v in latency.values())
    record = {
        "metric": f"HTTP serving load ({cfg.model}+xSlot, {cfg.img_size}px, "
                  f"{args.compute_dtype}, {args.clients} clients x {args.requests} requests, "
                  f"{args.payload} payload, maps_frac={args.maps_frac})",
        "value": done / wall, "unit": "img/s", "wall_s": wall, "errors": len(errors),
        "latency_ms": {k: {q: v * 1e3 for q, v in common.percentiles(vals).items()}
                       for k, vals in latency.items() if vals},
        "n": {k: len(v) for k, v in latency.items()},
        "engine": {"requests": post_stats["requests"] - pre["requests"],
                   "batches": post_stats["batches"] - pre["batches"],
                   "padded": post_stats["padded"] - pre["padded"],
                   "bucket_fill": common.fill_delta(pre["bucket_fill"],
                                                    post_stats["bucket_fill"])},
        "card": card, "device": str(device)}
    if errors:
        record["first_errors"] = errors[:5]
    common.emit(record, args.out)
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
