"""What the serving loops share: the program's engine over the benchmark's
seeded weights, the seeded image pool, the warm-up of every bucket, and the
reference's answers for a sample of requests.

The engine is the program's ``serve/engine.py::InferenceEngine`` with the
traffic's buckets, batching wait, in-flight bound and resolver threads; each
request is one uint8 image of the configured size through ``submit``, and
its answer holds the logits and the slot maps.
"""

from __future__ import annotations

import gc
from typing import Dict, List, Sequence

import numpy as np

from ..harness import Ctx, port_config, seeded_images
from ..reference import model as ref
from ..reference.precision import EXACT, Precision
from ..weights import make_weights

__all__ = ["ServeRun", "batch_fill", "reference_answers"]


class ServeRun:
    def __init__(self, ctx: Ctx):
        import torch

        from scouter_tpu_torch.serve.engine import InferenceEngine

        p = ctx.params
        self.ctx = ctx
        self.buckets = tuple(int(b) for b in p["buckets"])
        cfg = port_config(ctx, max(self.buckets))
        dtype = torch.bfloat16 if ctx.config["compute_dtype"] == "bfloat16" else None
        weights = make_weights(ref.param_spec(ctx.config), ctx.seed, ctx.device)
        self.engine = InferenceEngine(cfg, weights, buckets=self.buckets,
                                      max_wait_ms=float(p["max_wait_ms"]), compute_dtype=dtype,
                                      include_maps=True, max_inflight=int(p["max_inflight"]),
                                      resolvers=int(p["resolvers"]), device=ctx.device)
        del weights
        self.pool = seeded_images(ctx, int(p["pool"]), stream=4)
        for _ in range(2):
            for b in self.buckets:
                self.engine.infer_batch(self.pool[:b])

    def close(self) -> None:
        self.engine.close()
        self.engine = None
        gc.collect()


def batch_fill(before: Dict, after: Dict) -> float:
    """Live images over bucket slots of the batches dispatched between two
    ``stats()`` readings; None where none was."""
    live = slots = 0
    for key, count in after["bucket_fill"].items():
        n = count - before["bucket_fill"].get(key, 0)
        bucket, rows = (int(v) for v in key.split("/"))
        live += rows * n
        slots += bucket * n
    return live / slots if slots else None


def reference_answers(ctx: Ctx, images: np.ndarray, precision: Precision = EXACT,
                      block: int = 64) -> List[Dict[str, np.ndarray]]:
    """The reference's logits and slot maps for each image, in eval mode, in
    blocks of ``block``."""
    import torch

    W = make_weights(ref.param_spec(ctx.config), ctx.seed, ctx.device)
    out: List[Dict[str, np.ndarray]] = []
    with torch.no_grad():
        for s in range(0, len(images), block):
            x = torch.from_numpy(np.ascontiguousarray(images[s:s + block])).to(ctx.device)
            logits, _, attn = ref.forward(W, x, ctx.config, train=False, precision=precision)
            maps = ref.render_maps(attn, ctx.config)
            out += [{"logits": lg, "slot_maps": m} for lg, m in
                    zip(logits.float().cpu().numpy(), maps.cpu().numpy())]
    return out


def sampled(answers: Dict[int, Dict], keys: Sequence[int]) -> List[Dict[str, np.ndarray]]:
    return [{"logits": np.asarray(answers[k]["logits"]),
             "slot_maps": np.asarray(answers[k]["slot_maps"])} for k in keys]
