"""The serving engine against the sequential batch-1 loop, on one GPU.

    python examples/torch_bench_serve.py [--requests 256] [--buckets 1,4,16,32]
        [--max_wait_ms 5] [--compute_dtype bfloat16] [--out FILE]

Counterpart of the JAX package's ``examples/bench_serve.py``: a stream of
single-image requests through ``serve/engine.py::InferenceEngine``, which
coalesces them into its buckets, against the one-forward-per-image loop of
the reference's test.py flow, both serving the flagship resnest26d + xSlot
(seeded random weights) with the same function. One JSON line: the
engine's img/s, the loop's, their ratio, the device batches and padded
slots, the mean batch, and the largest difference between the engine's
logits and the loop's for the same images (they run the same function at
other batch sizes).

Runs on the card unless given ``--device cpu``; results also go to
``--out`` (default ``build/torch_bench_serve.jsonl``).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_bench_common as common  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    common.add_device_arg(p)
    p.add_argument("--requests", type=int, default=256)
    p.add_argument("--model", default="resnest26d")
    p.add_argument("--num_classes", type=int, default=10)
    p.add_argument("--channel", type=int, default=2048)
    p.add_argument("--img_size", type=int, default=224)
    p.add_argument("--buckets", default="1,4,16,32")
    p.add_argument("--max_wait_ms", type=float, default=5.0)
    p.add_argument("--compute_dtype", default="bfloat16", choices=["float32", "bfloat16"])
    p.add_argument("--out", default=os.path.join(common.BUILD, "torch_bench_serve.jsonl"))
    args = p.parse_args(argv)
    device, card = common.setup(args.device)

    import numpy as np
    import torch

    from scouter_tpu_torch.models import build_slot_model
    from scouter_tpu_torch.serve import InferenceEngine, make_serving_fn

    cfg = common.flagship(model=args.model, num_classes=args.num_classes, channel=args.channel,
                          img_size=args.img_size, batch_size=1)
    dtype = torch.bfloat16 if args.compute_dtype == "bfloat16" else None
    state_dict = build_slot_model(cfg, device="cpu").state_dict()
    images = np.random.RandomState(0).randint(
        0, 256, (args.requests, cfg.img_size, cfg.img_size, 3), np.uint8)

    # the sequential batch-1 loop (test.py's one forward an image)
    fn = make_serving_fn(cfg, state_dict, compute_dtype=dtype, device=device)
    fn(images[:1])["logits"].cpu()
    n_loop = min(64, args.requests)
    loop_logits = []
    t0 = time.perf_counter()
    for i in range(n_loop):
        loop_logits.append(fn(images[i:i + 1])["logits"].cpu())
    loop_img_s = n_loop / (time.perf_counter() - t0)

    buckets = tuple(int(b) for b in args.buckets.split(","))
    with InferenceEngine(cfg, state_dict, buckets=buckets, max_wait_ms=args.max_wait_ms,
                         compute_dtype=dtype, device=device) as eng:
        for b in buckets:  # every bucket warm before the timed stream
            eng.infer_batch(images[:b])
        pre = eng.stats()
        t0 = time.perf_counter()
        futures = [eng.submit(img) for img in images]
        results = [f.result(timeout=600) for f in futures]
        wall = time.perf_counter() - t0
        post = eng.stats()
    engine_logits = np.stack([np.asarray(r["logits"]) for r in results[:n_loop]])
    diff = float(np.abs(engine_logits - torch.cat(loop_logits).float().numpy()).max())
    batches = post["batches"] - pre["batches"]
    engine_img_s = args.requests / wall
    common.emit({
        "metric": f"serving engine throughput ({cfg.model}+xSlot, {cfg.img_size}px, "
                  f"{args.compute_dtype})",
        "requests": args.requests, "buckets": list(buckets), "value": engine_img_s,
        "unit": "img/s", "sequential_bs1_img_s": loop_img_s,
        "speedup_vs_sequential": engine_img_s / loop_img_s, "batches": batches,
        "padded": post["padded"] - pre["padded"],
        "mean_batch": (post["requests"] - pre["requests"]) / max(batches, 1),
        "bucket_fill": common.fill_delta(pre["bucket_fill"], post["bucket_fill"]),
        "max_abs_logit_diff_vs_sequential": diff, "card": card, "device": str(device)},
        args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
