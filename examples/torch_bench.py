"""Serving throughput and utilisation of the PyTorch port on one GPU.

    python examples/torch_bench.py [--int8] [--s2d] [--iters 60] [--out FILE]
    python examples/torch_bench.py --serving
    python examples/torch_bench.py --slot-kernel

Counterpart of the JAX package's ``bench.py``. Default: the flagship
resnest26d + xSlot (seeded random weights, 224 px, batch 70) through
``make_serving_fn`` with an f32 and a bf16 backbone (with ``--int8`` also
int8 pointwise convs over a bf16 backbone; with ``--s2d`` the stem's first
conv through space-to-depth), one JSON line each: img/s, achieved TFLOP/s
(the FLOPs of one call, counted by ``utils/profiling.py::model_cost_analysis``
on the f32 function, x calls / s) and ``mfu`` against the card's published
dense peak for the compute dtype, beside the card's name and power limit.

``--serving``: ``bench.py::serving_bench``'s CUB config (resnest50d, 200 x 5
slots, 260 px, bf16) at batch 1 and 16, ms per batch and per image; the
port's slot path is K1 (``slot_path`` "k1").
``--slot-kernel``: K1's forward against its plain version at
``bench.py::slot_kernel_check``'s shapes (N=81, d=64; S=30 at B=70, S=1000
at B=16) and tolerances (upd 1e-4 / 1e-3, attn 1e-4 / 2e-2).

Runs on the card unless given ``--device cpu``; results also go to
``--out`` (default ``build/torch_bench.jsonl``).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_bench_common as common  # noqa: E402

# bench.py:73-76's bars: upd tight, attn through the renorm's global sum
SLOT_KERNEL_BARS = {30: (1e-4, 1e-4), 1000: (1e-3, 2e-2)}


def timed_calls(fn, images, iters: int, device) -> float:
    """Seconds of ``iters`` calls after 3 warm-up calls, ending in a
    synchronize."""
    for _ in range(3):
        fn(images)
    common.sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(images)
    common.sync(device)
    seconds = time.perf_counter() - t0
    if not bool(out["logits"].isfinite().all()):
        raise SystemExit("non-finite logits")
    return seconds


def serving_rows(cfg, device, iters: int, int8: bool, s2d: bool, card):
    """One record a variant: f32, bf16 and (``int8``) int8 over bf16."""
    import numpy as np
    import torch

    from scouter_tpu_torch.models import build_slot_model
    from scouter_tpu_torch.serve import make_serving_fn
    from scouter_tpu_torch.utils import model_cost_analysis

    bk = {"s2d_stem": True} if s2d else None
    state_dict = build_slot_model(cfg, device="cpu", backbone_kwargs=bk).state_dict()
    images = torch.from_numpy(np.random.RandomState(3).randint(
        0, 256, (cfg.batch_size, cfg.img_size, cfg.img_size, 3), np.uint8)).to(device)
    variants = [("float32", None, None), ("bfloat16", torch.bfloat16, None)]
    if int8:
        variants.append(("int8", torch.bfloat16, "int8"))
    flops = None
    kind = common.card_kind(device)
    for name, dtype, quant in variants:
        fn = make_serving_fn(cfg, state_dict, compute_dtype=dtype, quant=quant, device=device,
                             backbone_kwargs=bk)
        if flops is None:  # the function's FLOPs, counted once on the f32 function
            flops = model_cost_analysis(fn, images)["flops"]
        seconds = timed_calls(fn, images, iters, device)
        record = {"metric": f"serving img/s ({cfg.model}+xSlot, {cfg.img_size}px, "
                            f"bs={cfg.batch_size}, {name}{', s2d stem' if s2d else ''})",
                  "value": cfg.batch_size * iters / seconds, "unit": "img/s",
                  "ms_per_batch": seconds / iters * 1e3, "flops_per_call": flops,
                  "card": card, "device": str(device)}
        record.update(common.utilisation(flops, iters, seconds, kind, name))
        yield record


def serving_bench(device, iters: int, card):
    """``bench.py::serving_bench``'s cells on K1."""
    import numpy as np
    import torch

    from scouter_tpu_torch.core import ScouterConfig
    from scouter_tpu_torch.models import build_slot_model
    from scouter_tpu_torch.serve import make_serving_fn

    cfg = ScouterConfig(model="resnest50d", dataset="CUB200", num_classes=200, channel=2048,
                        use_slot=True, slots_per_class=5, power=2, loss_status=1,
                        to_k_layer=3, lambda_value=10.0, img_size=260, batch_size=1,
                        pre_trained=False, seed=0)
    state_dict = build_slot_model(cfg, device="cpu").state_dict()
    fn = make_serving_fn(cfg, state_dict, compute_dtype=torch.bfloat16, device=device)
    for bs in (1, 16):
        images = torch.from_numpy(np.random.RandomState(bs).randint(
            0, 256, (bs, cfg.img_size, cfg.img_size, 3), np.uint8)).to(device)
        seconds = timed_calls(fn, images, iters, device)
        ms = seconds / iters * 1e3
        yield {"metric": "serving latency (resnest50d+xSlot S=1000, 260px, bf16)",
               "batch": bs, "slot_path": "k1", "value": ms, "unit": "ms/batch",
               "ms_per_image": ms / bs, "card": card, "device": str(device)}


def slot_kernel_check(device, card):
    """K1's forward against its plain version: one record, ``ok`` and the
    largest differences."""
    import numpy as np
    import torch

    from scouter_tpu_torch.ops.slot_kernel import xslot_iterations_fused, xslot_iterations_ref

    diffs, ok = {}, True
    for s, b in ((30, 70), (1000, 16)):
        n, d = 81, 64
        rng = np.random.RandomState(0)
        args = [torch.tensor(a, dtype=torch.float32, device=device) for a in (
            rng.randn(b, n, d) * 0.1, rng.randn(b, n, d) * 0.1, rng.randn(s, d) * 0.02,
            rng.randn(3 * d, d) * 0.05, rng.randn(3 * d, d) * 0.05,
            rng.randn(1, 3 * d) * 0.05, rng.randn(1, 3 * d) * 0.05)]
        with torch.no_grad():
            upd, attn = xslot_iterations_fused(*args)
            upd_r, attn_r = xslot_iterations_ref(*args)
        diffs[f"S{s}_upd"] = (upd - upd_r).abs().max().item()
        diffs[f"S{s}_attn"] = (attn - attn_r).abs().max().item()
        bar_upd, bar_attn = SLOT_KERNEL_BARS[s]
        ok = ok and diffs[f"S{s}_upd"] < bar_upd and diffs[f"S{s}_attn"] < bar_attn
    return {"metric": "slot_kernel_vs_plain_version", "ok": ok, "max_abs_diff": diffs,
            "bars": {f"S{s}": bars for s, bars in SLOT_KERNEL_BARS.items()}, "card": card,
            "device": str(device), "kernel": "k1" if device.type == "cuda" else "plain"}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    common.add_device_arg(p)
    p.add_argument("--serving", action="store_true", help="the CUB-scale serving cells")
    p.add_argument("--slot-kernel", action="store_true", dest="slot_kernel",
                   help="K1 against its plain version")
    p.add_argument("--int8", action="store_true", help="also int8 pointwise convs")
    p.add_argument("--s2d", action="store_true", help="the space-to-depth stem")
    p.add_argument("--iters", type=int, default=60)
    p.add_argument("--model", default=None, help="backbone (default: the flagship's)")
    p.add_argument("--img_size", type=int, default=None)
    p.add_argument("--batch", type=int, default=None)
    p.add_argument("--channel", type=int, default=None)
    p.add_argument("--out", default=os.path.join(common.BUILD, "torch_bench.jsonl"))
    args = p.parse_args(argv)
    device, card = common.setup(args.device)
    if args.slot_kernel:
        record = slot_kernel_check(device, card)
        common.emit(record, args.out)
        return 0 if record["ok"] else 1
    if args.serving:
        for record in serving_bench(device, args.iters, card):
            common.emit(record, args.out)
        return 0
    overrides = {k: v for k, v in (("model", args.model), ("img_size", args.img_size),
                                   ("batch_size", args.batch), ("channel", args.channel))
                 if v is not None}
    cfg = common.flagship(**overrides)
    for record in serving_rows(cfg, device, args.iters, args.int8, args.s2d, card):
        common.emit(record, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
