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
   backward kernel (xslot_bwd) on a cluster against ``xslot_bwd_ref`` at
   (70, 49, 30), (16, 81, 10), (16, 81, 125), d=48 (16, 49, 30), 384 px's
   (16, 144, 30) and B = 1, 4 and 16, equal bit for bit across two calls,
   its launches a call (the nodes of its CUDA graph, held to the launch
   calls torch.profiler records) held to its plan's, its time and bound at
   each, and the op's gradient against autograd through the plain
   version; then the backward where no cluster of 8 holds an element's
   share, on its tiled route, at the CUB recipe's (16, 81, 1000) at d=64
   and d=48 and at 448 px's (70, 196, 30), and on a cluster at d=48 (16,
   49, 30): the forward with hist against its plain version (and its time
   at (16, 81, 1000)), the backward against ``xslot_bwd_ref`` and the op's
   gradient against autograd through the plain version, bit for bit across
   two calls, with plans, times and bounds, the tiled route's launches a
   call (its CUDA graph's nodes, held to torch.profiler's launch calls; at
   most 50, and as many as ``TiledPlan.launches`` says), and its plan (tile
   widths, pieces, scratch) from the C library held to its Python copy;
   then the backward with bf16 residuals (a bf16 slot head) on a cluster at (70, 49, 30),
   (16, 49, 30) and (16, 81, 125) and on its tiled route at (16, 81, 1000)
   and (70, 196, 30): bf16 gradients equal bit for bit to the f32
   instance's on the same values rounded once, within one bf16 ulp of the
   plain version at max(1, max|ref|) (where missed, by no more than the f32
   instance misses its plain version on the same values), the same bits
   from run to run, its launches a call (graph nodes, held to the
   profiler's launch calls) held to its plan's, and its time in a CUDA
   graph beside the f32 instance's;
4. serve flagship resnest26d + xSlot (f32, seeded random weights) through
   ``InferenceEngine`` (requests from several threads) and the HTTP server
   (``.npy`` bodies, one with ``?maps=1``, and ``/healthz``), counting the
   kernel launches of this phase;
5. the same weights on the card and on the CPU: logits within 1e-3;
6. serving throughput of ``make_serving_fn`` at batch 70, f32 and bf16, the
   bf16 model's BatchNorm tensors f32 and its uint8 slot maps' largest level
   difference from f32's;
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
   one repeated batch, whose loss must fall, with f32 state after the steps;
11. images on disk, from the fixtures committed in ``tests/torch_fixtures``:
   each JPEG decoded by nvJPEG and staged to 260 px on the card against
   Pillow's staged pixels (max, 99.9th percentile and mean level difference;
   the mean within JPEG_MEAN_LEVEL_BAR), each PNG staged on the card equal
   to the CPU path, the decoder's count equal to the JPEGs decoded, decode
   img/s at batch 16; the CUB recipe in bf16 through the train CLI for one
   epoch on a CUB-200 tree of 200 classes x (2 train + 1 val) images (25
   train steps, 13 val batches; K1 counted: hist 25, hist-free 13, tiled
   backward 25, cluster 0; nvJPEG's decodes equal to the tree's JPEGs),
   cold- and warm-cache train img/s beside the stand-in's, the cache within
   its byte bound; on a smaller tree, with cuDNN deterministic,
   ``--preempt_save true --ckpt_async true`` uninterrupted, interrupted by a
   real SIGTERM after train step 7 (a checkpoint at (0, 7)) and resumed:
   the resumed parameters, buffers and AdamW state equal the uninterrupted
   run's bit for bit (else within two uninterrupted runs' spread, printed);
   the explain CLI on the tree's checkpoint and a val JPEG (K1 once,
   hist-free; 401 PNGs read back); the HTTP server answering a JPEG body
   and a PNG body, whose logits equal a ``.npy`` body's of the same staged
   pixels; Pillow never imported (phases 12-14 run before phase 11);
12. a bf16 slot head (``--compute_dtype bfloat16 --slot_head_dtype
   compute``) through the train CLI: the flagship for 3 epochs at batch 70
   (K1's backward on a cluster with bf16 residuals once a train step, 9,
   as the f32 head has in phase 7) and the CUB recipe for one epoch at
   batch 16 (its tiled route, 16), K1's counts zeroed just before and read
   just after; checkpoints f32; each checkpoint's val loss with the bf16
   head within 0.08 x max(1, |f32-head loss|);
13. ``python -m scouter_tpu_torch.serve.cli`` in two subprocesses on the
   flagship's bf16-head checkpoint: a dynamic-batch artifact in f32 and one
   in bf16, each verified by the CLI itself; loaded here and run at batches
   1, 4 and 70 against the live ``make_serving_fn``: logits within the
   CLI's tolerances, maps within 1 level, K1 launched once a call through
   the artifact; int8 serving at batch 70 within 0.05 of f32's logit scale
   with the decisive top-1 equal (tests/test_serve.py:394-418);
14. img/s at batch 70 of the live function in f32, bf16 and int8 (f32 and
   bf16 compute) and of both artifacts, and the train img/s of the bf16 and
   the f32 slot head over a bf16 backbone, flagship and CUB, on one
   repeated batch whose loss must fall, the state f32 after the steps.

15. the ResNet zoo: one full-depth representative per mechanism (resnet50,
   resnext50_32x4d, seresnext26d/26t/26tn_32x4d, ecaresnet50d_pruned,
   res2net50_26w_4s, skresnet18, skresnext50_32x4d, resnetblur50,
   gluon_senet154, resnet50 at output stride 16, resnest26d at 8, resnet18
   with the space-to-depth stem) with the same seeded weights on the card
   and on the CPU at 224 px, batch 2: features and logits within 1e-3 of
   the CPU's scale; then the flagship's config on resnet50 (S=30, N=49,
   batch 70, f32) through phases 4-7's entry points: the engine and HTTP,
   card vs CPU logits, ``make_serving_fn`` img/s in f32 and bf16, the train
   CLI for two epochs and a resumed third (K1's hist, hist-free and cluster
   backward counts equal to the train steps and val batches, its tiled
   route never), the explain CLI on that checkpoint (K1 once, K2 never),
   train img/s; and the model built with ``output_stride=16`` (N=196): one
   train step at batch 4 on the card and on the CPU from the same weights
   (the loss within 1e-3, every gradient within 0.1 in norm), K1's
   backward on its tiled route once and held to its plain version on the
   step's own residuals, and its launches a call (graph nodes, held to the
   profiler's launch calls) held to its plan;
   at output stride 8 (N=784) the slot model's K1 forward raises
   ValueError (its documented reach, ROADMAP Queue C); the phase's
   seconds.
16. the XAI baseline suite at the width README.md:96-97 documents
   (resnest26d, backbone only, 260 px, 10 classes): a no-slot model trained
   one epoch through the train CLI; ``scouter_tpu_torch.explain.compare_cli``
   from that checkpoint with the torchcam_vis method set and ``--fast`` over
   all 10 classes, then with ``--methods deeplift`` (captum_vis), every PNG
   read back and every map finite; SS-CAM and IS-CAM (at reduced samples,
   printed), deconvnet, linear approximation, EBP and IBA through
   ``compare_methods`` and contrastive EBP on one class; card against CPU
   on the same weights, image and draws for every single-shot method
   (contrastive EBP stage by stage: its map cancels two relevances), RISE
   at 400 masks (1e-4 of the map's scale) and extremal, IGOS and IBA at 2
   iterations (1e-3), a map past its bar held to the CPU's float64 run or
   else in norm (XAI_F64_FACTOR, XAI_NORM_BAR); the pointing game on a
   16-image VOC-like tree (fixture JPEGs and blob PNGs with XML boxes):
   ``voc_dataset`` -> the caffe VGG16 and ResNet50 (random init, 20
   classes) -> ``run_pointing_benchmark`` with gradient (both) and EBP
   (ResNet50) saliency into a sqlite store, each map held to the CPU's as
   above (a map held in norm giving the CPU's hit or miss); K1 and K2
   launched 0 times over the phase; neither Pillow nor matplotlib imported;
   each method's seconds with the card's name and power limit.

17. the second backbone slice: one full-depth representative per mechanism
   (efficientnet_b0, tf_efficientnet_b0, efficientnet_es,
   efficientnet_cc_b0_4e, mixnet_m, mobilenetv3_large_100,
   efficientnet_b2_pruned, regnety_032, dla60_res2next, ese_vovnet39b_evos,
   ese_vovnet99b_iabn, densenetblur121d, hrnet_w18_small, senet154, resnet50
   with CBAM) card against CPU at 224 px, batch 2, logits from each
   model's own head (``forward_head``); the flagship's config on
   efficientnet_b2 at 260 px (N=81, ``--channel 1408``) through phase 15's
   entry points: the engine and HTTP, card vs CPU logits, serving img/s in
   f32 and bf16, the train CLI for two epochs and a resumed third, the
   explain CLI, a train step card vs CPU and train img/s; K1's forward and
   backward calls in a train step at (70, 81, 30), counted (1 / 1 / 1 on a
   cluster / 0 tiled) and each held to its plain version; densenet121 +
   xSlot (N=64) served through the engine and HTTP, card vs CPU logits,
   serving and train img/s and a train step card vs CPU; the phase's
   seconds.

18. the last ten backbone families: one full-depth representative per
   mechanism (dpn68b, dpn107, tresnet_m, tresnet_xl, selecsls42b,
   selecsls84, inception_v3, inception_v4, inception_resnet_v2, xception,
   gluon_xception65, gluon_xception71, nasnetalarge, pnasnet5large) card
   against CPU at 224 px, batch 2, within 1e-3 of the CPU's scale; the
   flagship's config on xception at its published 299 px (N=100,
   ``--channel 2048``) through phase 15's entry points: the engine and
   HTTP, card vs CPU logits, serving img/s in f32 and bf16, the train CLI
   for two epochs and a resumed third, the explain CLI, a train step card
   vs CPU and train img/s; K1's forward and backward calls in a train step
   at (70, 100, 30), counted (1 / 1 / 1 on a cluster / 0 tiled) and each
   held to its plain version and timed; nasnetalarge + xSlot at 331 px
   (N=121, ``--channel 4032``) served through the engine and HTTP, card vs
   CPU logits, serving img/s at batch 70 in f32 and bf16, one train step at
   batch 4 card vs CPU (K1 with hist once, its backward on a cluster once)
   and train img/s at batch 16 with ``torch.cuda.max_memory_allocated``;
   the phase's seconds.

19. the optimizer and scheduler factories, extra losses, augmentation,
   TF preprocessing, MNIST variants and the utils package at the
   flagship's width (resnest26d + xSlot, batch 70, 224 px, f32): one
   ``make_train_step`` step with each of the 15 factory optimizers and
   ``lookahead_adamw`` (lr 1e-4, weight decay 0.01) from one saved state,
   the card's updated parameters and optimizer state held to the port's
   CPU optimizer applied to the card's own pre-step parameters and
   gradients (1e-6 of max(1, max|p|)), each optimizer's step timed alone;
   ten nadam steps on a repeated batch (the loss falls) with ``ModelEma``
   held to a CPU replay, ``CheckpointSaver(max_history=2)`` ranking the
   steps by ``evaluate_top1``, ``update_summary``'s rows, ``Timer`` and a
   ``trace()`` of two steps naming K1's kernels; every AutoAugment op at
   levels 0, 5 and 10 (both signs where signed) and AutoAugment 'v0' /
   'original' and RandAugment(2, 9) at seed 0 on 70 fixtures staged to 260
   px, card vs CPU (equal, or 1 level on at most 0.1% of the pixels), with
   each policy's img/s grouped by op and image by image;
   ``TfPreprocessTransform`` at 224 px from the fixtures' bytes, eval and
   train, against its CPU twin in a child process (boxes equal, PNG bit for
   bit, JPEG within JPEG_MEAN_LEVEL_BAR); mixup (within 1e-6) and random
   erasing (bit for bit) card vs CPU on seeded CPU draws; the three extra
   losses on the flagship's logits card vs CPU (1e-6 relative), top-1 and
   top-5 equal; ``load_mnist_variant`` on written FashionMNIST and QMNIST
   files; K1's counts over the phase (forward with hist and backward once
   a train step, a hist-free forward once an eval forward); the phase's
   seconds.

20. training and serving over ``torch.distributed`` on the one card: (a)
   ``python -m torch.distributed.run --standalone --nproc_per_node 1
   chip_smoke.py dist-cli`` (one process, NCCL, world size 1) runs the train
   CLI on the flagship (batch 70, 224 px, one epoch of the stand-in) with
   ``--mesh_shape 1 --sync_bn true``, ``--mesh_shape 1 --sync_bn false`` and
   ``--mesh_shape 1,1 --zero1 true``: finite metrics, the reference's
   checkpoint names, K1's hist, hist-free and backward launches equal to the
   train steps and val batches, each epoch's unrounded averages within
   DIST_LOSS_BAR of the same CLI run here without a mesh and the launcher;
   then its train img/s with a (1,) mesh over NCCL and without a mesh; (b)
   two gloo ranks on the card (``chip_smoke.py dist-rank``, both on
   ``cuda:0``): one flagship train step at batch 35 a rank in each BN mode
   against one rank's step here on the same 70 images (per-replica BN: the
   mean of each half's own step), the loss within DIST_STEP_LOSS_BAR and
   each gradient before the update within STEP_GRAD_NORM_BAR in norm (one
   that is zero in exact arithmetic, the split-attention's fc1 bias before
   its BatchNorm, no further from the float64 step than twice the f32
   step), the
   parameters equal on both ranks (a checksum), K1 with hist and its
   backward once on each rank, a checkpoint written by rank 0 alone, and
   the global train img/s; (c) ``InferenceEngine(mesh=)`` over a mesh of the
   card: logits bit for bit with the engine without one at buckets 1, 4
   and 16; the phase's seconds.

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


def xslot_bwd_bound(b, n, s, d, iters=3, elem=4):
    """(bound ms, what bounds it) for one backward call: per element
    ``iters`` attention recomputes (two (S,N,d) products) and backwards
    (four), ``iters`` - 1 GRU recomputes (two (S,d)x(d,3d) products) and
    backwards (four: dx, dh, dW_ih, dW_hh), 12.2 MFLOP at the flagship, all
    in f32, against HBM over k, v, the GRU weights (``elem`` bytes each: 2
    for bf16 residuals), hist, du and dattn (f32) read once and dk, dv and
    the seven parameter gradients (``elem`` bytes each) written once."""
    flops = b * (iters * 6 * (2 * s * n * d) + (iters - 1) * 6 * (2 * s * d * 3 * d))
    nbytes = (elem * (2 * b * n * d + 2 * (3 * d * d + 3 * d) + 2 * b * n * d
                      + 2 * (3 * d * d + 3 * d) + s * d)
              + 4 * (b * iters * s * d + b * s * d + b * s * n))
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


def cluster_bwd_launches(label, plan, res, cot):
    """One cluster backward call's launches (``profiled_launches``), held to
    the plan's count; returns the count."""
    import torch

    from scouter_tpu_torch.ops import slot_kernel

    with torch.no_grad():
        count = profiled_launches(lambda: slot_kernel._launch_bwd(*res, *cot))
    want = plan.launches("bwd")
    print(f"xslot_bwd {label} (cluster {plan.cluster}): {count} launches in one call, "
          f"graph nodes held to torch.profiler's launch calls (the plan: {want})", flush=True)
    if count != want:
        fail(f"the cluster backward made {count} launches in one call at {label}; its plan "
             f"says {want}")
    return count


def phase_kernel_grad(entry):
    """K1 with hist, its backward kernel (xslot_bwd) on a cluster against
    xslot_bwd_ref and the op's gradient against autograd through the plain
    version, the backward's bit-for-bit repeat, its launches a call under
    torch.profiler and its times and bounds at every cluster shape: (70, 49,
    30), (16, 81, 10), (16, 81, 125), d=48 (16, 49, 30), 384 px's (16, 144,
    30) and the engine's buckets B = 1, 4, 16; adds the hist figures to ``entry`` and returns the
    backward's kernels-line entry.

    The op's gradients are those of ``sum(upd**2) + sum(attn)``, all taken
    with the one cotangent (2 upd, 1) of the float64 plain forward; the
    backward kernel gets the same cotangent and the kernel's hist."""
    import torch

    from scouter_tpu_torch.ops import slot_kernel

    fused, ref = slot_kernel.xslot_iterations_fused, slot_kernel.xslot_iterations_ref
    names = ("k", "v", "initial_slots", "w_ih", "w_hh", "b_ih", "b_hh")
    d, worst, worst_bwd = 64, entry["max_abs_err"], 0.0
    plans, by_shape = {}, {}
    # the forward with hist to bench.py:85-86's bars: 1e-4 up to N=81, past it
    # upd < 1e-3 and attn < 2e-2 (as the tiled phase holds 448 px)
    for b, n, s, dd in ((70, 49, 30, 64), (16, 81, 10, 64), (16, 81, 125, 64),
                        (16, 49, 30, 48), (16, 144, 30, 64)):
        bar_out, bar_attn = (1e-4, 1e-4) if n <= 81 else (1e-3, 2e-2)
        label = f"{b},{n},{s}" + ("" if dd == d else f",d={dd}")
        args = xslot_inputs(b, n, s, dd, "cuda")
        with torch.no_grad():
            upd, attn, hist = slot_kernel._launch(*args, 3, emit_hist=True)
            upd_r, attn_r, hist_r = slot_kernel.xslot_fwd_ref(*args, emit_hist=True)
        e_hist = max((hist - hist_r).abs().max().item(), (upd - upd_r).abs().max().item())
        e_attn = (attn - attn_r).abs().max().item()
        print(f"xslot_fwd+hist B={b} N={n} S={s} d={dd}: max|d hist, upd| {e_hist:.3e} (bar "
              f"{bar_out:g})  max|d attn| {e_attn:.3e} (bar {bar_attn:g})", flush=True)
        if not (e_hist <= bar_out and e_attn <= bar_attn):
            fail(f"xslot_fwd with hist disagrees with xslot_fwd_ref at {label}")
        if n <= 81:
            worst = max(worst, e_hist, e_attn)

        args64 = [a.double() for a in args]
        with torch.no_grad():
            upd64, attn64 = ref(*args64)
        cot64 = (2 * upd64, torch.ones_like(attn64))
        cot = tuple(t.float() for t in cot64)
        # the backward kernel on its own, against its plain version
        plan = check_plan("bwd", b, n, s, dd, args[0].device)
        if plan.tiled:
            fail(f"xslot_bwd took its tiled route at {label}")
        plans[label] = [plan.cluster, plan.ctas_per_sm]
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
        print(f"xslot_bwd B={b} N={n} S={s} d={dd} (cluster {plan.cluster}): two calls on the "
              f"same inputs {'equal bit for bit' if same else 'DIFFER'}", flush=True)
        if not same:
            fail(f"xslot_bwd is not deterministic at {label}")
        count = cluster_bwd_launches(label, plan, res, cot)
        with torch.no_grad():
            ms = graph_ms(lambda: slot_kernel._launch_bwd(*res, *cot), reps=50)
        bound_ms, bound_by = xslot_bwd_bound(b, n, s, dd)
        print(f"xslot_bwd B={b} N={n} S={s} d={dd} (cluster {plan.cluster}): {ms:.5f} ms in a "
              f"CUDA graph, bound {bound_ms:.6f} ms ({bound_by})", flush=True)
        by_shape[label] = dict(ms=ms, bound_ms=bound_ms, bound_by=bound_by,
                               launches_per_call=count,
                               plan=[plan.cluster, plan.slots_per_cta, plan.smem_bytes])
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
            plan = check_plan("bwd", bb, n, s, d, u.device)
            plans[f"{bb},{n},{s}"] = [plan.cluster, plan.ctas_per_sm]
            same = all(torch.equal(x, y) for x, y in zip(got, slot_kernel._launch_bwd(*r, *c)))
            times[bb] = (graph_ms(lambda: slot_kernel._launch_bwd(*r, *c)),
                         xslot_bwd_bound(bb, n, s, d)[0])
        print(f"xslot_bwd B={bb} N={n} S={s} (cluster {plan.cluster}): {times[bb][0]:.5f} ms "
              f"in a CUDA graph, bound {times[bb][1]:.6f} ms; two calls on the same inputs "
              f"{'equal bit for bit' if same else 'DIFFER'}", flush=True)
        if not same:
            fail(f"xslot_bwd is not deterministic at B={bb} N={n} S={s}")
        label = f"{bb},{n},{s}"
        by_shape[label] = dict(ms=times[bb][0], bound_ms=times[bb][1], bound_by=xslot_bwd_bound(
            bb, n, s, d)[1], launches_per_call=cluster_bwd_launches(label, plan, r, c),
            plan=[plan.cluster, plan.slots_per_cta, plan.smem_bytes])
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
            "bound_ms_by_batch": {str(k): t[1] for k, t in sorted(times.items())},
            "by_shape": by_shape}


def check_tiled_plans(shapes):
    """The tiled route's plan from the C library (``xslot_tiled_plan`` and the
    scratch it sizes) against ``slot_kernel.tiled_plan``, its Python copy, at
    each (B, N, S, d); returns the plans."""
    import torch

    from scouter_tpu_torch.ops import slot_kernel

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plans = {}
    for b, n, s, d in shapes:
        plan = slot_kernel.launch_tiled_plan(b, n, s, d, torch.device("cuda"))
        py = slot_kernel.tiled_plan(b, n, s, d, sms)
        prods = ", ".join(f"{k} {p.rows} rows x {p.tile_cols}-column tiles"
                          + (f" in {p.pieces} pieces" if p.pieces > 1 else "")
                          for k, p in plan.products.items())
        print(f"xslot_bwd tiled plan B={b} N={n} S={s} d={d}: {plan.scratch_floats} scratch "
              f"floats, row passes {'in the epilogues' if plan.fused else 'apart'}; {prods}",
              flush=True)
        if plan != py:
            fail(f"the tiled route's plan at B={b} N={n} S={s} d={d} is {plan} in the C "
                 f"library and {py} in slot_kernel.tiled_plan")
        plans[f"{b},{n},{s},d={d}"] = plan
    return plans


PROFILER_SESSIONS = 5  # torch.profiler sessions a launch count is held to
# the runtime calls that put a kernel or a memset on a stream
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaMemsetAsync", "cuLaunchKernel",
                "cuLaunchKernelEx")


def graph_launches(fn):
    """The kernels and memsets one call of ``fn`` puts on its stream: the
    nodes of a CUDA graph captured from that call (``cuGraphGetNodes``)."""
    import ctypes

    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    nodes = ctypes.c_size_t(0)
    err = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(nodes))
    if err:
        fail(f"cuGraphGetNodes returned CUresult {err}")
    return nodes.value


def profiled_launches(fn):
    """The kernels and memsets one call of ``fn`` puts on the card: the nodes
    of a CUDA graph captured from one call (``graph_launches``), held to the
    launch calls (``LAUNCH_CALLS``) torch.profiler records on the host for
    one call in each of ``PROFILER_SESSIONS`` sessions: every session must
    record exactly as many. Its device records are printed where a session
    has fewer, with the kernels it lacks beside the fullest session's: late
    in ``chip_smoke``'s long process the tracer loses the first device
    records of most sessions (24 or 25 of 36 at the OS16 shape), while the
    host's launch calls stay whole; it never records more."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    nodes = graph_launches(fn)
    calls, records = [], []
    for _ in range(PROFILER_SESSIONS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = prof.events()
        calls.append(sum(ev.device_type != torch.autograd.DeviceType.CUDA
                         and ev.name in LAUNCH_CALLS for ev in events))
        records.append(collections.Counter(
            ev.name for ev in events if ev.device_type == torch.autograd.DeviceType.CUDA))
    counts = [sum(names.values()) for names in records]
    fullest = records[counts.index(max(counts))]
    for i, names in enumerate(records):
        if counts[i] != nodes:
            print(f"torch.profiler session {i + 1} of {PROFILER_SESSIONS}: {calls[i]} launch "
                  f"calls, {counts[i]} device records, the graph {nodes} nodes; the records "
                  f"lack {json.dumps(dict(fullest - names))} beside the fullest session",
                  flush=True)
    if calls != [nodes] * PROFILER_SESSIONS or max(counts) > nodes:
        fail(f"torch.profiler's sessions recorded {calls} launch calls and {counts} device "
             f"records for one call, the call's CUDA graph {nodes} nodes")
    return nodes


def phase_kernel_grad_tiled(entry):
    """K1's backward where it leaves the cluster: at the CUB recipe's (16,
    81, 1000), at that shape with d=48 and at 448 px's (70, 196, 30) on its
    tiled route, and at d=48 (16, 49, 30) on a cluster. At each, the forward
    with hist against its plain version to bench.py:85-86's S=1000 bars, the
    backward against ``xslot_bwd_ref`` and the op's gradient against
    autograd through the plain version to chip_smoke's gradient bar, two
    backward calls equal bit for bit, its plan, time in a CUDA graph and
    bound; on the tiled route the launches of one call
    (``profiled_launches``), held to ``TiledPlan.launches`` and to at most 50; the tiled
    plans held to their Python copy (also at (64, 81, 1000)). Adds the
    forward with hist's time at (16, 81, 1000) to the forward's ``entry``;
    returns the tiled route's kernels-line entry."""
    import torch

    from scouter_tpu_torch.ops import slot_kernel

    fused, ref = slot_kernel.xslot_iterations_fused, slot_kernel.xslot_iterations_ref
    names = ("k", "v", "initial_slots", "w_ih", "w_hh", "b_ih", "b_hh")
    worst, times, tiled = 0.0, {}, {}
    tiled_plans = check_tiled_plans(((16, 81, 1000, 64), (64, 81, 1000, 64),
                                     (16, 81, 1000, 48), (70, 196, 30, 64)))
    for b, n, s, d in ((16, 81, 1000, 64), (16, 81, 1000, 48), (70, 196, 30, 64),
                       (16, 49, 30, 48)):
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
        if (b, n, s, d) == (16, 81, 1000, 64):  # the CUB train step's forward
            with torch.no_grad():
                hist_ms = graph_ms(lambda: slot_kernel._launch(*args, 3, emit_hist=True),
                                   reps=20, iters=10)
            hist_bound_ms, hist_bound_by = xslot_bound(b, n, s, d, hist_iters=3)
            print(f"xslot_fwd+hist B={b} N={n} S={s} d={d}: {hist_ms:.5f} ms in a CUDA graph, "
                  f"bound {hist_bound_ms:.5f} ms ({hist_bound_by})", flush=True)
            entry.update(cub_hist_ms=hist_ms, cub_hist_bound_ms=hist_bound_ms,
                         cub_hist_bound_by=hist_bound_by)
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
            with torch.no_grad():
                count = profiled_launches(lambda: slot_kernel._launch_bwd(*res, *cot))
            want_count = tiled_plans[label].launches(3)
            print(f"xslot_bwd B={b} N={n} S={s} d={d} (tiled route): {count} launches in one "
                  f"call, graph nodes held to torch.profiler's launch calls (TiledPlan.launches: "
                  f"{want_count}, bar 50)", flush=True)
            if count != want_count or count > 50:
                fail(f"the tiled route made {count} launches in one call at {label}: "
                     f"TiledPlan.launches says {want_count}, the bar is 50")
            times[label]["launches_per_call"] = count
            tiled[label] = times[label]
            worst = max(worst, err)
    if list(tiled) != ["16,81,1000,d=64", "16,81,1000,d=48", "70,196,30,d=64"]:
        fail(f"xslot_bwd took its tiled route at {list(tiled)}")
    cub = tiled["16,81,1000,d=64"]
    return {"name": "xslot_bwd_tiled", "route": "cuda",
            "source": "scouter_tpu_torch/csrc/xslot_bwd.cu",
            "replaces": "scouter_tpu/ops/slot_pallas.py:168", "max_abs_err": worst,
            "ms": cub["ms"], "plain_ms": cub["plain_ms"], "bound_ms": cub["bound_ms"],
            "bound_by": cub["bound_by"], "library_ms": None,
            "launches_per_call": cub["launches_per_call"], "by_shape": times}


BF16_ULP = 2.0 ** -7  # one bf16 ulp at 1.0 (8 bits of significand)
# K1's backward with bf16 residuals: the cluster route's shapes (the
# flagship's train batch, a batch of 16 and (16, 81, 125)) and the tiled
# route's (the CUB recipe's and 448 px's)
BF16_BWD_SHAPES = ((70, 49, 30), (16, 49, 30), (16, 81, 125), (16, 81, 1000), (70, 196, 30))


def bf16_ulp(x: float) -> float:
    """One bf16 ulp at |x| (a power of two times BF16_ULP)."""
    import math

    return BF16_ULP * 2.0 ** math.floor(math.log2(abs(x)))


def phase_kernel_grad_bf16():
    """K1's backward with bf16 residuals (a bf16 slot head in training), on
    both routes, against ``xslot_bwd_ref`` on the same bf16 inputs on the
    card: each gradient in bf16, equal bit for bit to the f32 instance's on
    the same values rounded once to bf16 (the conversion is exact and the
    arithmetic after it the f32 instance's), and within one bf16 ulp of the
    plain version's at max(1, max|ref|). Where that ulp is missed, the f32
    instance on the same values misses the plain version by as much: the
    renorm has no epsilon, and a row sum near zero amplifies f32 rounding
    (Queue C of ROADMAP.md); the figures are printed, f32's beside them.
    Also: two calls equal bit for bit; its launches a call
    (``profiled_launches``) held to its plan's (2 on a cluster, ``TiledPlan.launches``
    on the tiled route, one more than f32 for the pass that converts the
    residuals); its time in a CUDA graph beside the f32 instance's at the
    same shape in this run, the plain version's and the bound. Returns the
    kernels-line entries of the cluster and the tiled instances."""
    import torch

    from scouter_tpu_torch.ops import slot_kernel

    names = ("k", "v", "initial_slots", "w_ih", "w_hh", "b_ih", "b_hh")
    d = 64
    by_shape = {}
    for b, n, s in BF16_BWD_SHAPES:
        label = f"{b},{n},{s}"
        args = [a.to(torch.bfloat16) for a in xslot_inputs(b, n, s, d, "cuda")]
        plan = check_plan("bwd", b, n, s, d, args[0].device, bf16=True)
        with torch.no_grad():
            upd, attn, hist = slot_kernel._launch(*args, 3, emit_hist=True)
        cot = (2 * upd, torch.ones_like(attn))
        res = (args[0], args[1], args[3], args[4], args[5], args[6], hist)
        res32 = tuple(t.float() for t in res)
        with torch.no_grad():
            got = slot_kernel._launch_bwd(*res, *cot)
            again = slot_kernel._launch_bwd(*res, *cot)
            got32 = slot_kernel._launch_bwd(*res32, *cot)
            want = slot_kernel.xslot_bwd_ref(*res, *cot)
            want32 = slot_kernel.xslot_bwd_ref(*res32, *cot)
            exact = slot_kernel.xslot_bwd_ref(*(t.double() for t in res + cot))
        rounded = [n_ for n_, g, g32 in zip(names, got, got32)
                   if not torch.equal(g, g32.to(torch.bfloat16))]
        if rounded:
            fail(f"xslot_bwd bf16 at {label}: {', '.join(rounded)} differ from the f32 "
                 "instance's gradient on the same values rounded once to bf16")
        figures, worst, missed = [], 0.0, []
        for name, g, w, x, g32, w32 in zip(names, got, want, exact, got32, want32):
            if g.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
                fail(f"xslot_bwd bf16 at {label}: {name} in {g.dtype}, the plain version's "
                     f"in {w.dtype}; both must be bfloat16")
            diff = (g.float() - w.float()).abs()
            err = diff.max().item()
            bar = bf16_ulp(max(1.0, w.float().abs().max().item()))
            e64 = (g.double() - x).abs().max().item()
            p64 = (w.double() - x).abs().max().item()
            r64 = (x.to(torch.bfloat16).double() - x).abs().max().item()
            figures.append(f"{name} {err:.3e} (bar {bar:.3e}; from f64: kernel {e64:.3e}, "
                           f"plain {p64:.3e}, f64 rounded to bf16 {r64:.3e})")
            if not err <= bar:
                at = int(diff.argmax())
                e32 = (g32 - w32).abs().max().item()
                print(f"xslot_bwd bf16 at {label}: {name} {err:.3e} from the plain version, "
                      f"{int((diff > bar).sum())} elements past one bf16 ulp ({bar:.3e}); the "
                      f"largest at flat index {at}: kernel {g.flatten()[at].item():.6e}, "
                      f"plain {w.flatten()[at].item():.6e}, f64 {x.flatten()[at].item():.6e}. "
                      f"The f32 instance on the same values: {e32:.3e} from the f32 plain "
                      f"version, {(g32.double() - x).abs().max().item():.3e} from f64 (plain "
                      f"{(w32.double() - x).abs().max().item():.3e})", flush=True)
                if not e32 > err - bar:
                    missed.append(name)
            worst = max(worst, err)
        route = "tiled route" if plan.tiled else f"cluster {plan.cluster}"
        print(f"xslot_bwd bf16 B={b} N={n} S={s} ({route}), max|d| from xslot_bwd_ref on the "
              f"same bf16 inputs: " + ", ".join(figures), flush=True)
        if missed:
            fail(f"xslot_bwd bf16 at {label}: {', '.join(missed)} more than one bf16 ulp "
                 "from the plain version, and further than the f32 instance on the same "
                 "values is from its plain version")
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        if not same:
            fail(f"xslot_bwd bf16 is not deterministic at {label}")
        if plan.tiled:
            tiled = slot_kernel.launch_tiled_plan(b, n, s, d, args[0].device, bf16=True)
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            if tiled != slot_kernel.tiled_plan(b, n, s, d, sms, bf16=True):
                fail(f"the bf16 tiled plan at {label} is {tiled} in the C library and "
                     f"{slot_kernel.tiled_plan(b, n, s, d, sms, bf16=True)} in Python")
            want_count = tiled.launches(3)
        else:
            want_count = plan.launches("bwd")
        with torch.no_grad():
            count = profiled_launches(lambda: slot_kernel._launch_bwd(*res, *cot))
        if count != want_count:
            fail(f"xslot_bwd bf16 made {count} launches in one call at {label}; its plan "
                 f"says {want_count}")
        reps, iters = (10, 10) if plan.tiled else (50, 20)
        with torch.no_grad():
            ms = graph_ms(lambda: slot_kernel._launch_bwd(*res, *cot), reps=reps, iters=iters)
            ms32 = graph_ms(lambda: slot_kernel._launch_bwd(*res32, *cot), reps=reps,
                            iters=iters)
            plain_ms = cuda_ms(lambda: slot_kernel.xslot_bwd_ref(*res, *cot), 10)
        bound_ms, bound_by = xslot_bwd_bound(b, n, s, d, elem=2)
        print(f"xslot_bwd bf16 B={b} N={n} S={s} ({route}): two calls equal bit for bit; "
              f"{count} launches a call (plan: {want_count}); {ms:.5f} ms in a CUDA graph, "
              f"the f32 instance {ms32:.5f} ms, xslot_bwd_ref {plain_ms:.4f} ms, bound "
              f"{bound_ms:.6f} ms ({bound_by})", flush=True)
        by_shape[label] = dict(route=route, ms=ms, f32_ms=ms32, plain_ms=plain_ms,
                               bound_ms=bound_ms, bound_by=bound_by, launches_per_call=count,
                               max_abs_err=worst)
    entries = []
    for name, main, shapes in (("xslot_bwd_bf16", "70,49,30", ("70,49,30", "16,49,30",
                                                                "16,81,125")),
                               ("xslot_bwd_tiled_bf16", "16,81,1000", ("16,81,1000",
                                                                       "70,196,30"))):
        top = by_shape[main]
        entries.append({"name": name, "route": "cuda",
                        "source": "scouter_tpu_torch/csrc/xslot_bwd.cu",
                        "replaces": "scouter_tpu/ops/slot_pallas.py:168",
                        "max_abs_err": max(by_shape[k]["max_abs_err"] for k in shapes),
                        "ms": top["ms"], "f32_ms": top["f32_ms"], "plain_ms": top["plain_ms"],
                        "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
                        "library_ms": None, "launches_per_call": top["launches_per_call"],
                        "launches": 0, "by_shape": {k: by_shape[k] for k in shapes}})
    return entries


def post(url: str, body: bytes) -> dict:
    import urllib.request

    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


def phase_serve(cfg, state_dict, map_side: int = 7):
    """Engine + HTTP on the card, the slot maps ``map_side`` square; returns
    the kernel launches of this phase."""
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
            if r["slot_maps"].shape != (cfg.num_classes, map_side, map_side):
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
    print(f"serve {cfg.model}: {len(images)} engine requests + 4 HTTP requests answered in "
          f"{seconds:.2f} s; engine stats {json.dumps(stats)}; xslot_fwd launches {launches}",
          flush=True)
    if launches == 0:
        fail("the serving path launched no xslot_fwd kernel")
    if slot_kernel.xslot_iterations_fused.hist_launches:
        fail("the serving path launched the training (hist) build of xslot_fwd")
    return launches


def phase_gpu_vs_cpu(cfg, state_dict, relative: bool = False):
    """Serving logits and maps of the same weights and images on the card and
    on the CPU: logits within rtol/atol 1e-3, and with ``relative`` also
    within 1e-3 of the CPU's largest logit (phase 17's EfficientNet at init
    serves logits ~1e-18, where atol 1e-3 holds nothing)."""
    import numpy as np

    from scouter_tpu_torch.serve import make_serving_fn

    images = np.random.RandomState(2).randint(0, 256, (2, cfg.img_size, cfg.img_size, 3),
                                               np.uint8)
    gpu = make_serving_fn(cfg, state_dict, device="cuda")(images)
    cpu = make_serving_fn(cfg, state_dict, device="cpu")(images)
    lg, lc = gpu["logits"].cpu().numpy(), cpu["logits"].numpy()
    maps = np.abs(gpu["slot_maps"].cpu().numpy().astype(int) - cpu["slot_maps"].numpy()).max()
    print(f"gpu vs cpu {cfg.model}: max|d logits| {np.abs(lg - lc).max():.3e} (bar rtol/atol "
          f"1e-3), "
          f"max|d slot_maps| {maps}", flush=True)
    if not np.allclose(lg, lc, rtol=1e-3, atol=1e-3):
        fail(f"{cfg.model} logits on the card differ from the CPU's:\n{lg}\n{lc}")
    if relative:
        rel = np.abs(lg - lc).max() / np.abs(lc).max()
        print(f"gpu vs cpu {cfg.model}: max|d logits| / max|CPU logits| {rel:.3e} (bar 1e-3; "
              f"max|CPU logits| {np.abs(lc).max():.3e})", flush=True)
        if not rel <= 1e-3:
            fail(f"{cfg.model} logits on the card differ from the CPU's by {rel:.3e} of "
                 "their scale")


def phase_throughput(cfg, state_dict, card: str):
    """Serving img/s in f32 and bf16; the bf16 model's BatchNorm weights,
    biases and running statistics must be f32 (flax's f32 ``param_dtype``),
    and the largest level difference of its uint8 maps from f32's is
    printed."""
    import numpy as np
    import torch

    from scouter_tpu_torch.serve import make_serving_fn

    bs = cfg.batch_size
    images = torch.from_numpy(np.random.RandomState(3).randint(
        0, 256, (bs, cfg.img_size, cfg.img_size, 3), np.uint8)).cuda()
    maps, rates = {}, {}
    for name, dtype in (("float32", None), ("bfloat16", torch.bfloat16)):
        fn = make_serving_fn(cfg, state_dict, compute_dtype=dtype, device="cuda")
        bns = [m for m in fn.model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
        wrong = [t.dtype for m in bns
                 for t in (m.weight, m.bias, m.running_mean, m.running_var)
                 if t.dtype != torch.float32]
        print(f"serving {name}: {len(bns)} BatchNorms, their parameters and running "
              f"statistics {'f32' if not wrong else wrong}", flush=True)
        if not bns or wrong:
            fail(f"{name} serving holds BatchNorm tensors in {set(wrong)}, not float32")
        maps[name] = fn(images)["slot_maps"].cpu().numpy().astype(int)
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
        rates[name] = bs / dt
        print(f"throughput make_serving_fn {cfg.model} bs={bs} {name}: {bs / dt:.1f} img/s "
              f"({dt * 1e3:.2f} ms/batch) on {card}", flush=True)
    gap = np.abs(maps["bfloat16"] - maps["float32"])
    print(f"serving {cfg.model} bs={bs}: bf16 vs f32 uint8 slot maps on the card, max level "
          f"difference {gap.max()}, mean {gap.mean():.3f}, share of pixels more than 2 "
          f"levels apart {(gap > 2).mean():.4f}", flush=True)
    return rates


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


def flagship_flags(tmp: str, model: str = "resnest26d", channel: int = 2048,
                   img_size: int = 224):
    """The CLIs' flags for the flagship (or its config on another backbone,
    of ``channel`` features, at ``img_size``) on the card, the synthetic
    stand-in (nothing at ``--dataset_dir``) and ``tmp`` as the output
    directory."""
    import os

    return ["--device", "cuda", "--dataset", "ImageNet", "--model", model,
            "--num_classes", "10", "--channel", str(channel), "--hidden_dim", "64",
            "--slots_per_class", "3", "--to_k_layer", "3", "--power", "2",
            "--loss_status", "1", "--lambda_value", "1", "--img_size", str(img_size),
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


def phase_train(tmp: str, model: str = "resnest26d", channel: int = 2048,
                img_size: int = 224):
    """Flagship training (on ``model``, ``flagship_flags``' ``channel`` and
    ``img_size``) through the train CLI on the card: two epochs, then a
    resume for a third; returns K1's forward and backward launches over
    both runs."""
    import math
    import os

    from scouter_tpu_torch.ops import slot_kernel
    from scouter_tpu_torch.train import cli

    fused = slot_kernel.xslot_iterations_fused
    flags = flagship_flags(tmp, model, channel, img_size) + ["--lr_drop", "1"]
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
        print(f"train run {run} ({model}): epochs {started}, {len(epochs) * train_steps} "
              f"train steps, "
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


# K1's counters (slot_kernel.xslot_iterations_fused's attributes)
K1_COUNTERS = ("launches", "hist_launches", "bwd_launches", "bwd_tiled_launches",
               "bwd_bf16_launches", "bwd_tiled_bf16_launches")
BF16_HEAD = ["--compute_dtype", "bfloat16", "--slot_head_dtype", "compute"]


def k1_counts(reset: bool = False):
    """K1's launch counters, zeroed first with ``reset``."""
    from scouter_tpu_torch.ops import slot_kernel

    fused = slot_kernel.xslot_iterations_fused
    if reset:
        for name in K1_COUNTERS:
            setattr(fused, name, 0)
    return {name: getattr(fused, name) for name in K1_COUNTERS}


def train_bf16_head(what: str, flags, epochs: int, train_steps: int, val_batches: int,
                    tiled: bool):
    """One bf16-head training run through the train CLI on the card, K1's
    counts zeroed just before and read just after: the metrics finite, K1
    with hist once a train step, hist-free once a val batch, the backward
    once a train step on its route (``tiled`` or a cluster), every backward
    call on bf16 residuals; the checkpoint f32. Returns the counts and the
    checkpoint's state dict."""
    import math
    import os

    import torch

    from scouter_tpu_torch.train import cli

    k1_counts(reset=True)
    t0 = time.monotonic()
    _, lines = run_cli(cli.main, flags)
    torch.cuda.synchronize()
    seconds = time.monotonic() - t0
    counts = k1_counts()
    metrics = logged_metrics(lines)
    values = [v for vs in metrics.values() for v in vs]
    steps = epochs * train_steps
    print(f"{what} bf16-head train: {epochs} epochs, {steps} train steps and "
          f"{epochs * val_batches} val batches in {seconds:.2f} s with data, eval and "
          f"checkpoints; K1 counts {json.dumps(counts)}", flush=True)
    if len(metrics["train loss:"]) != epochs or not all(map(math.isfinite, values)):
        fail(f"{what} bf16-head train: logged metrics {metrics}")
    route, other = (("bwd_tiled_launches", "bwd_launches") if tiled
                    else ("bwd_launches", "bwd_tiled_launches"))
    bf16_route = route.replace("_launches", "_bf16_launches")
    want = {"hist_launches": steps, "launches": steps + epochs * val_batches, route: steps,
            bf16_route: steps, other: 0}
    wrong = {k: (counts[k], v) for k, v in want.items() if counts[k] != v}
    if wrong:
        fail(f"{what} bf16-head train: K1 counts (got, expected) {wrong}")
    name = [n for n in os.listdir(flags[flags.index("--output_dir") + 1])
            if n.endswith("use_slot_checkpoint.pth")]
    payload = torch.load(os.path.join(flags[flags.index("--output_dir") + 1], name[0]),
                         map_location="cpu", weights_only=True)
    tensors, moments = check_f32_state(f"{what} bf16-head checkpoint", payload["model"],
                                       payload["optimizer"]["state"])
    print(f"{what} bf16-head checkpoint {name[0]}: {tensors} model tensors and {moments} "
          "AdamW moments, all float32", flush=True)
    return counts, payload["model"]


def head_val_losses(what: str, cfg, state_dict, datasets):
    """The val loss of the same weights with the bf16 slot head and with the
    f32 one (both over a bf16 backbone): within 0.08 x max(1, |f32-head
    loss|) (tests/test_train.py:139-150). Returns both."""
    from scouter_tpu_torch.train import Trainer

    val = {}
    for head in ("compute", "float32"):
        trainer = Trainer(cfg.replace(compute_dtype="bfloat16", slot_head_dtype=head),
                          datasets=datasets)
        trainer.model.load_state_dict(state_dict)
        val[head] = trainer.run_epoch(0, "val")["loss"]
        del trainer
    gap = abs(val["compute"] - val["float32"])
    print(f"{what} val loss of the bf16-head checkpoint: bf16 head {val['compute']:.6f}, f32 "
          f"head {val['float32']:.6f}, |d| {gap:.3e} (bar 0.08 x max(1, |f32 head|))",
          flush=True)
    if not gap <= 0.08 * max(1.0, abs(val["float32"])):
        fail(f"{what}: the bf16-head val loss leaves the bar of the f32 head's")
    return val


def head_train_rates(what: str, cfg, datasets, card: str):
    """Train img/s of the bf16 slot head and of the f32 one (both over a bf16
    backbone) at cfg's batch on one repeated batch: 3 warm-up steps, 10
    timed ones ending in a synchronize; the loss must fall and the state
    stay f32. Returns {head: img/s}."""
    import torch

    from scouter_tpu_torch.data import preprocess_batch
    from scouter_tpu_torch.train import Trainer

    bs, ds = cfg.batch_size, datasets[0]
    images = preprocess_batch(torch.from_numpy(ds.images[:bs]).cuda(), dataset=cfg.dataset,
                              img_size=cfg.img_size).permute(0, 3, 1, 2).contiguous()
    batch = {"image": images, "label": torch.from_numpy(ds.labels[:bs]).long().cuda()}
    rates = {}
    for head in ("compute", "float32"):
        trainer = Trainer(cfg.replace(compute_dtype="bfloat16", slot_head_dtype=head),
                          datasets=datasets)
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
        check_f32_state(f"{what} {head}-head train state", state.model.state_dict(),
                        state.optimizer.state)
        label = "bf16 head" if head == "compute" else "f32 head"
        print(f"{what} bf16 {label} train loss on one repeated batch of {bs}, 13 steps: "
              f"{', '.join(f'{v:.4f}' for v in losses)}", flush=True)
        if not losses[-1] < losses[0]:
            fail(f"{what} {label}: the loss did not fall on a repeated batch: {losses}")
        rates[head] = bs / dt
        print(f"{what} train throughput bf16 backbone, {label}, bs={bs}: {bs / dt:.1f} img/s "
              f"({dt * 1e3:.2f} ms/step) on {card}", flush=True)
        del trainer, state
    return rates


def phase_flagship_bf16_head(tmp: str):
    """The flagship with a bf16 slot head through the train CLI on the card:
    3 epochs of the synthetic stand-in (9 train steps, 6 val batches), K1's
    backward on a cluster with bf16 residuals once a step, as the f32 head's
    9 in phase 7; its checkpoint f32, and that checkpoint's val loss with
    the bf16 head and with the f32 one. Returns (K1's counts, config, the
    checkpoint's weights, the val losses)."""
    import os

    from scouter_tpu_torch.core import ScouterConfig
    from scouter_tpu_torch.data import select_dataset

    flags = flagship_flags(tmp) + BF16_HEAD + ["--epochs", "3", "--lr_drop", "1"]
    counts, state_dict = train_bf16_head("flagship", flags, 3, 256 // 70, -(-128 // 70),
                                         tiled=False)
    cfg = ScouterConfig(**FLAGSHIP).replace(
        device="cuda", output_dir=tmp, dataset_dir=os.path.join(tmp, "no_dataset"),
        compute_dtype="bfloat16", slot_head_dtype="compute")
    datasets = (select_dataset(cfg, train=True), select_dataset(cfg, train=False))
    val = head_val_losses("flagship", cfg, state_dict, datasets)
    return counts, cfg, state_dict, val, datasets


def phase_cub_bf16_head(tmp: str):
    """The CUB-200 recipe with a bf16 slot head through the train CLI on the
    card for one epoch on the stand-in (16 train steps, 8 val batches): K1's
    tiled backward on bf16 residuals once a step; its checkpoint f32 and that
    checkpoint's val loss with the bf16 head and with the f32 one. Returns
    (K1's counts, config, datasets, the val losses)."""
    import os

    from scouter_tpu_torch.core import ScouterConfig
    from scouter_tpu_torch.data import select_dataset

    counts, state_dict = train_bf16_head("CUB", cub_flags(tmp) + BF16_HEAD[2:], 1, 256 // 16,
                                         128 // 16, tiled=True)
    cfg = ScouterConfig(**CUB).replace(device="cuda", output_dir=tmp,
                                       dataset_dir=os.path.join(tmp, "no_dataset"),
                                       slot_head_dtype="compute")
    datasets = (select_dataset(cfg, train=True), select_dataset(cfg, train=False))
    val = head_val_losses("CUB", cfg, state_dict, datasets)
    return counts, cfg, datasets, val


def start_exports(tmp: str):
    """``python -m scouter_tpu_torch.serve.cli`` in two subprocesses at once,
    on the flagship's bf16-head checkpoint in ``tmp``: a dynamic-batch
    artifact in f32 and one in bf16 (whose slot head is bf16, as trained).
    Returns {dtype: (artifact path, process)}."""
    import os

    procs = {}
    for name, extra in (("float32", []), ("bfloat16", ["--serve_dtype", "bfloat16"])):
        path = os.path.join(tmp, f"flagship_{name}.pt2")
        cmd = [sys.executable, "-m", "scouter_tpu_torch.serve.cli",
               *flagship_flags(tmp), *BF16_HEAD, "--export_path", path,
               "--serve_batch", "dynamic", *extra]
        procs[name] = (path, subprocess.Popen(cmd, cwd=str(ROOT), stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT, text=True))
    return procs


def finish_exports(procs):
    """Wait for the export CLIs: each exits 0 having written its artifact and
    verified its round trip (its own check). Returns {dtype: path}."""
    paths = {}
    for name, (path, proc) in procs.items():
        out, _ = proc.communicate(timeout=600)
        lines = [line for line in out.splitlines() if line.strip()]
        print(f"serve.cli ({name}, in a subprocess, exit {proc.returncode}):\n  "
              + "\n  ".join(lines[-4:]), flush=True)
        if proc.returncode != 0 or not any(line.startswith("round-trip verified")
                                           for line in lines):
            fail(f"serve.cli {name} failed:\n{out[-4000:]}")
        paths[name] = path
    return paths


def serving_rate(fn, images, iters: int = 20) -> float:
    """img/s of ``fn(images)``: 3 warm-up calls, then ``iters`` ending in a
    synchronize; its logits must be finite."""
    import torch

    for _ in range(3):
        fn(images)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(images)
    torch.cuda.synchronize()
    if not torch.isfinite(out["logits"]).all():
        fail("non-finite logits in a serving throughput run")
    return images.shape[0] * iters / (time.perf_counter() - t0)


def phase_export_check(cfg, state_dict, paths):
    """The artifacts the CLI wrote, loaded here, against the live serving
    function on the same weights at batches 1, 4 and 70: logits within the
    CLI's tolerances (rtol/atol 2e-5 in f32, 3e-2 in bf16,
    scouter_tpu/serve/cli.py:80-82), uint8 maps within 1 level (in bf16
    within max(1, the live bf16 maps' level difference from f32's on the
    same images), the bar of tests/test_torch_models.py's bf16 maps: the
    artifact runs batch 1 padded to 2, where cuDNN's bf16 kernels round
    otherwise; against the live function on that padded batch, within 1
    level), and K1's forward launched once a call through the artifact,
    hist-free (its counts zeroed just before and read just after). Then int8
    serving at batch 70 against the float path (tests/test_serve.py:394-418):
    the top-1 equal wherever the float margin exceeds twice the int8 error,
    and the logits' error as a share of the logit scale, held to 0.05 on the
    flagship's backbone and classifier (use_slot false: the same resnest26d
    and its 20 pointwise convs). With the slot head the share is printed,
    not held: the renorm (no epsilon) amplifies the quantisation noise, and
    the JAX package's own int8 serving misses 0.05 there too (0.0695 at 96
    px on the CPU, PERF.md). Returns the loaded artifacts, the live
    functions, the int8 figures and the artifact's K1 launches."""
    import numpy as np
    import torch

    from scouter_tpu_torch.serve import load_artifact, make_serving_fn

    def levels(a, b):
        return int(np.abs(a["slot_maps"].cpu().numpy().astype(int)
                          - b["slot_maps"].cpu().numpy().astype(int)).max())

    calls, lives, launches = {}, {}, 0
    for name, dtype, tol in (("float32", None, 2e-5), ("bfloat16", torch.bfloat16, 3e-2)):
        call = load_artifact(paths[name], device="cuda")
        live = make_serving_fn(cfg, state_dict, compute_dtype=dtype, device="cuda")
        for b in (1, 4, 70):
            images = torch.from_numpy(np.random.RandomState(10 + b).randint(
                0, 256, (b, cfg.img_size, cfg.img_size, 3), np.uint8)).cuda()
            k1_counts(reset=True)
            got = call(images)
            torch.cuda.synchronize()
            counts = k1_counts()
            want = live(images)
            lg, lw = got["logits"].float().cpu().numpy(), want["logits"].float().cpu().numpy()
            maps = levels(got, want)
            bar = 1 if dtype is None else max(1, levels(want, lives["float32"](images)))
            padded = ""
            if b < 2:  # the artifact ran it padded to its least batch
                pad = torch.cat([images, images.new_zeros((2 - b, *images.shape[1:]))])
                same = {k: v[:b] for k, v in live(pad).items()}
                err = (got["logits"] - same["logits"]).abs().max().item()
                padded = (f"; against the live function on the padded batch: max|d logits| "
                          f"{err:.3e}, max|d maps| {levels(got, same)} (bar 1)")
                if not (err <= tol + tol * same["logits"].abs().max().item()
                        and levels(got, same) <= 1):
                    fail(f"artifact {name} at batch {b}: differs from the live function on "
                         "the padded batch")
            print(f"artifact {name} batch {b}: max|d logits| from the live function "
                  f"{np.abs(lg - lw).max():.3e} (bar rtol/atol {tol:g}), max|d maps| {maps} "
                  f"(bar {bar}){padded}; K1 launches through the artifact "
                  f"{counts['launches']} (hist {counts['hist_launches']})", flush=True)
            if lg.shape != (b, cfg.num_classes) or not np.allclose(lg, lw, rtol=tol, atol=tol):
                fail(f"artifact {name} at batch {b}: logits differ from the live function's")
            if maps > bar:
                fail(f"artifact {name} at batch {b}: slot maps differ by {maps} levels")
            if counts["launches"] != 1 or counts["hist_launches"]:
                fail(f"artifact {name} at batch {b}: K1 counts {counts}, expected one "
                     "hist-free launch")
            launches += counts["launches"]
        calls[name], lives[name] = call, live

    images = torch.from_numpy(np.random.RandomState(9).randint(
        0, 256, (cfg.batch_size, cfg.img_size, cfg.img_size, 3), np.uint8)).cuda()
    # the backbone and classifier alone: the checkpoint's backbone, a seeded
    # classifier
    from scouter_tpu_torch.models import build_slot_model

    plain_cfg = cfg.replace(use_slot=False)
    plain_sd = build_slot_model(plain_cfg, device="cpu").state_dict()
    plain_sd.update({k: v for k, v in state_dict.items() if k.startswith("backbone.")})
    int8 = {}
    for name, dtype, c, sd, held in (
            ("float32", None, cfg, state_dict, False),
            ("bfloat16", torch.bfloat16, cfg, state_dict, False),
            ("float32_no_slot", None, plain_cfg, plain_sd, True)):
        q = make_serving_fn(c, sd, compute_dtype=dtype, quant="int8", device="cuda")
        convs = sum(m.substitute is not None for m in q.model.modules()
                    if hasattr(m, "substitute"))
        ref_fn = (lives[name] if name in lives
                  else make_serving_fn(c, sd, compute_dtype=dtype, device="cuda"))
        ref = ref_fn(images)["logits"].float().cpu().numpy()
        got = q(images)["logits"].float().cpu().numpy()
        err = np.abs(ref - got).max()
        rel = err / max(np.abs(ref).max(), 1e-3)
        srt = np.sort(ref, axis=1)
        decisive = srt[:, -1] - srt[:, -2] > 2 * err
        agree = bool(np.array_equal(ref[decisive].argmax(1), got[decisive].argmax(1)))
        print(f"int8 serving ({name}, {convs} pointwise convs in int8) batch "
              f"{cfg.batch_size}: max|d logits| from the float path {err:.3e}, {rel:.4f} of "
              f"the logit scale ({'bar 0.05' if held else 'printed, not held'}); top-1 equal "
              f"on the {int(decisive.sum())} decisive rows: {agree}", flush=True)
        if convs != 20 or not agree or (held and not rel < 0.05):
            fail(f"int8 serving ({name}) leaves tests/test_serve.py's bars")
        int8[name] = dict(fn=q, convs=convs, rel_err=float(rel), decisive=int(decisive.sum()),
                          top1_agree=agree)
    return calls, lives, int8, images, launches


def phase_serving_rates(calls, lives, int8, images, card: str):
    """Serving img/s at batch 70 of the live function in f32, bf16 and int8
    (f32 and bf16 compute), and of the loaded f32 and bf16 artifacts."""
    rates = {}
    for name in ("float32", "bfloat16"):
        rates[f"live_{name}"] = serving_rate(lives[name], images)
        rates[f"artifact_{name}"] = serving_rate(calls[name], images)
        rates[f"int8_{name}"] = serving_rate(int8[name]["fn"], images)
    for key, rate in rates.items():
        print(f"serving throughput bs={images.shape[0]} {key}: {rate:.1f} img/s on {card}",
              flush=True)
    return rates


def phase_bf16_head_and_export(tmp: str, card: str):
    """Phases 12-14: bf16-head training of the flagship (then its export in
    two subprocesses while the CUB recipe trains with a bf16 head), the
    artifacts and int8 against the live serving function, and the img/s of
    serving and of both heads' training. Returns the figures."""
    import tempfile as _tempfile

    from scouter_tpu_torch.serve.server import load_state_dict

    flag_counts, cfg, _, flag_val, flag_datasets = phase_flagship_bf16_head(tmp)
    state_dict, source = load_state_dict(cfg)
    if source is None:
        fail("the bf16-head flagship checkpoint was not found for export")
    procs = start_exports(tmp)
    try:
        with _tempfile.TemporaryDirectory() as cub_tmp:
            cub_counts, cub_cfg, cub_datasets, cub_val = phase_cub_bf16_head(cub_tmp)
        paths = finish_exports(procs)
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    calls, lives, int8, images, artifact_launches = phase_export_check(cfg, state_dict, paths)
    rates = phase_serving_rates(calls, lives, int8, images, card)
    return {"flagship_k1_counts": flag_counts, "cub_k1_counts": cub_counts,
            "flagship_val_loss": flag_val, "cub_val_loss": cub_val,
            "flagship_train_img_per_s": head_train_rates("flagship", cfg, flag_datasets, card),
            "cub_train_img_per_s": head_train_rates("CUB", cub_cfg, cub_datasets, card),
            "serving_img_per_s": rates, "artifact_launches": artifact_launches,
            "int8": {k: {f: v[f] for f in ("convs", "rel_err", "decisive", "top1_agree")}
                     for k, v in int8.items()}}


# phase 11's cold- and warm-cache epoch img/s when the Loader decoded on the
# consumer's thread (this script on NVIDIA H100 80GB HBM3 at 700 W)
CONSUMER_THREAD_FOLDER_RATES = (154.9, 217.7)
# the committed image fixtures (tests/torch_fixtures/make_fixtures.py)
FIXTURES = ROOT / "tests" / "torch_fixtures"
FIXTURE_JPEGS = ("rgb420_500x375.jpg", "rgb444_375x500.jpg", "progressive_500x333.jpg",
                 "gray_500x375.jpg")
FIXTURE_PNGS = ("rgb_filters_300x200.png", "palette_trns_240x180.png",
                "gray_alpha_200x150.png", "rgba_220x160.png")
# the nvJPEG decode's bar against Pillow's staged pixels: mean absolute level
# difference (the IDCT and the chroma upsampling differ from libjpeg-turbo's)
JPEG_MEAN_LEVEL_BAR = 1.0


def write_cub_tree(root: str, entries):
    """A CUB-200-2011 tree at ``root`` from the fixtures: ``entries`` lists
    (class id, is_train) per image, in images.txt order; image k is a copy of
    fixture k mod 8. Returns {"train"|"val": number of JPEGs} for the tree."""
    import os
    import shutil

    fixtures = FIXTURE_JPEGS + FIXTURE_PNGS
    lines = {"images.txt": [], "image_class_labels.txt": [], "train_test_split.txt": []}
    jpegs = {"train": 0, "val": 0}
    for k, (c, train) in enumerate(entries):
        src = fixtures[k % len(fixtures)]
        name = f"{c:03d}.Bird_{c}/Bird_{c}_{k}{os.path.splitext(src)[1]}"
        os.makedirs(os.path.join(root, "images", os.path.dirname(name)), exist_ok=True)
        shutil.copyfile(FIXTURES / src, os.path.join(root, "images", name))
        lines["images.txt"].append(f"{k + 1} {name}")
        lines["image_class_labels.txt"].append(f"{k + 1} {c}")
        lines["train_test_split.txt"].append(f"{k + 1} {int(train)}")
        jpegs["train" if train else "val"] += src.endswith(".jpg")
    for fname, rows in lines.items():
        with open(os.path.join(root, fname), "w") as f:
            f.write("\n".join(rows) + "\n")
    return jpegs


def tree_flags(tree: str, out: str):
    """The CUB bf16 recipe's train CLI flags on the tree at ``tree``."""
    flags = cub_flags(out)
    at = flags.index("--dataset_dir")
    return flags[:at + 1] + [tree] + flags[at + 2:]


def phase_folder_decode(card: str):
    """Each JPEG fixture decoded by nvJPEG and staged to 260 px on the card
    against Pillow's staged pixels (committed beside the fixtures): the mean
    level difference within JPEG_MEAN_LEVEL_BAR; each PNG fixture staged on
    the card equal to the CPU path bit for bit; the decoder's count equal to
    the JPEGs decoded; then decode img/s at batch 16, uncached."""
    import numpy as np
    import torch

    from scouter_tpu_torch.data import FolderDataset
    from scouter_tpu_torch.data._decode import decode_file, decode_jpeg, stage

    pillow = np.load(FIXTURES / "staged_260.npz")
    decode_jpeg.decodes = 0
    for name in FIXTURE_JPEGS:
        got = stage(decode_jpeg((FIXTURES / name).read_bytes(), "cuda"), 260)
        diff = np.abs(got.cpu().numpy().astype(np.int16) - pillow[name].astype(np.int16))
        print(f"nvJPEG vs Pillow, {name} staged to 260 px: max {diff.max()} levels, "
              f"99.9th percentile {np.percentile(diff, 99.9):.1f}, mean {diff.mean():.4f}",
              flush=True)
        if not diff.mean() <= JPEG_MEAN_LEVEL_BAR:
            fail(f"{name}: nvJPEG's staged pixels are {diff.mean():.4f} levels from Pillow's "
                 f"on average (bar {JPEG_MEAN_LEVEL_BAR})")
    if decode_jpeg.decodes != len(FIXTURE_JPEGS):
        fail(f"decode_jpeg counted {decode_jpeg.decodes} nvJPEG decodes for "
             f"{len(FIXTURE_JPEGS)} JPEGs")
    for name in FIXTURE_PNGS:
        card_px = decode_file(str(FIXTURES / name), 260, "cuda")
        if not card_px.is_cuda or not torch.equal(card_px.cpu(),
                                                  decode_file(str(FIXTURES / name), 260, "cpu")):
            fail(f"{name}: the card's staged PNG differs from the CPU path's")
    print(f"PNG fixtures {', '.join(FIXTURE_PNGS)}: staged on the card bit for bit as on the "
          "CPU", flush=True)

    items = [(str(FIXTURES / FIXTURE_JPEGS[i % 3]), 0) for i in range(16)]
    ds = FolderDataset(items, 260, "CUB200", cache_bytes=0, device="cuda")
    ds.gather(np.arange(16))
    torch.cuda.synchronize()
    before = decode_jpeg.decodes
    t0 = time.perf_counter()
    for _ in range(5):
        ds.gather(np.arange(16))
    torch.cuda.synchronize()
    rate = 80 / (time.perf_counter() - t0)
    if decode_jpeg.decodes - before != 80:
        fail(f"decode_jpeg counted {decode_jpeg.decodes - before} decodes for 80 uncached JPEGs")
    print(f"decode throughput: FolderDataset.gather of 16 uncached color JPEGs (500x375, "
          f"375x500, 500x333) staged to 260 px on the card: {rate:.1f} img/s on {card}",
          flush=True)
    if "PIL" in sys.modules:
        fail("Pillow was imported on the card's decode path")


def phase_folder_train(tmp: str, card: str):
    """The CUB-200 recipe in bf16 through the train CLI for one epoch on a
    CUB tree of 200 classes x (2 train + 1 val) images laid out from the
    fixtures: 25 train steps and 13 val batches, K1 counted (hist 25,
    hist-free 13, tiled backward 25, cluster 0), nvJPEG's decodes equal to
    the tree's JPEGs (each decoded once, uncached); then train img/s over a
    cold and a warm cache beside the stand-in's, with the cache within its
    byte bound. Returns the tree, the output directory, K1's forward
    launches and its tiled backward's in the CLI run."""
    import math
    import os

    import numpy as np
    import torch

    from scouter_tpu_torch.core import ScouterConfig
    from scouter_tpu_torch.data import FolderDataset, select_dataset
    from scouter_tpu_torch.data._decode import decode_jpeg
    from scouter_tpu_torch.ops import slot_kernel
    from scouter_tpu_torch.train import Trainer, cli

    tree, out = os.path.join(tmp, "cub_tree"), os.path.join(tmp, "cub_tree_out")
    jpegs = write_cub_tree(tree, [(c, i < 2) for c in range(1, 201) for i in range(3)])
    train_steps, val_batches = 400 // 16, -(-200 // 16)
    fused = slot_kernel.xslot_iterations_fused
    fused.launches = fused.hist_launches = fused.bwd_launches = fused.bwd_tiled_launches = 0
    decode_jpeg.decodes = 0
    t0 = time.monotonic()
    _, lines = run_cli(cli.main, tree_flags(tree, out))
    torch.cuda.synchronize()
    seconds = time.monotonic() - t0
    counts = (fused.hist_launches, fused.launches - fused.hist_launches,
              fused.bwd_tiled_launches, fused.bwd_launches)
    decodes = decode_jpeg.decodes
    metrics = logged_metrics(lines)
    values = [v for vs in metrics.values() for v in vs]
    print(f"CUB tree train: 600 files ({jpegs['train']} + {jpegs['val']} JPEGs), 1 epoch, "
          f"{train_steps} train steps and {val_batches} val batches in {seconds:.2f} s with "
          f"decode, eval and the checkpoint; xslot_fwd launches with hist {counts[0]}, without "
          f"{counts[1]}; xslot_bwd tiled {counts[2]}, on a cluster {counts[3]}; nvJPEG decodes "
          f"{decodes}", flush=True)
    if counts != (train_steps, val_batches, train_steps, 0):
        fail(f"CUB tree train: K1 counts {counts}, expected ({train_steps}, {val_batches}, "
             f"{train_steps}, 0)")
    if decodes != jpegs["train"] + jpegs["val"]:
        fail(f"CUB tree train: {decodes} nvJPEG decodes for {jpegs} JPEGs, each once uncached")
    if len(metrics["train loss:"]) != 1 or not all(map(math.isfinite, values)):
        fail(f"CUB tree train: logged metrics {metrics}")

    cfg = ScouterConfig(**CUB).replace(device="cuda", dataset_dir=tree)
    ds_train = select_dataset(cfg, train=True)
    if not isinstance(ds_train, FolderDataset):
        fail(f"select_dataset on the tree gave {type(ds_train).__name__}")
    trainer = Trainer(cfg, datasets=(ds_train, select_dataset(cfg, train=False)))
    trainer_prefetch = trainer.loader_train.prefetch
    rates = {}
    for epoch, name in ((0, "cold cache"), (1, "warm cache")):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        trainer.run_epoch(epoch, "train")
        torch.cuda.synchronize()
        rates[name] = 400 / (time.perf_counter() - t1)
    if not ds_train.cached_bytes <= ds_train.cache_bytes or \
            ds_train.cached_bytes != 400 * 260 * 260 * 3:
        fail(f"the tree's cache holds {ds_train.cached_bytes} bytes (bound "
             f"{ds_train.cache_bytes}, expected all 400 images)")
    del trainer
    stand_in = Trainer(cfg.replace(dataset_dir=os.path.join(out, "no_dataset")))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    stand_in.run_epoch(0, "train")
    torch.cuda.synchronize()
    rates["synthetic stand-in"] = 256 // 16 * 16 / (time.perf_counter() - t1)
    del stand_in
    print(f"CUB bf16 train epoch img/s at batch 16, Loader (producer thread, prefetch "
          f"{trainer_prefetch}) and decode included: "
          + ", ".join(f"{k} {v:.1f}" for k, v in rates.items())
          + f"; the tree's cache {ds_train.cached_bytes} bytes of {ds_train.cache_bytes} on "
          f"the card, on {card} (the Loader decoding on the consumer's thread measured cold "
          f"{CONSUMER_THREAD_FOLDER_RATES[0]} and warm {CONSUMER_THREAD_FOLDER_RATES[1]} on "
          f"NVIDIA H100 80GB HBM3 at 700 W)", flush=True)
    if "PIL" in sys.modules:
        fail("Pillow was imported on the card's train path")
    return tree, out, counts[0] + counts[1], counts[2]


def _state_tensors(path: str):
    """(name, tensor) of a checkpoint's parameters, buffers and AdamW state."""
    import torch

    payload = torch.load(path, map_location="cpu", weights_only=True)
    out = list(payload["model"].items())
    for key, st in sorted(payload["optimizer"]["state"].items()):
        out += [(f"optimizer.{key}.{k}", v) for k, v in sorted(st.items())]
    return out, payload


def _largest_difference(a, b) -> float:
    return max(float((x.double() - y.double()).abs().max()) if x.numel() else 0.0
               for (_, x), (_, y) in zip(a, b))


def phase_folder_preempt(tmp: str):
    """Preemption on a tree (160 train images, 16 val: 10 train steps), the
    CUB bf16 recipe with ``--preempt_save true --ckpt_async true`` and
    cuDNN deterministic: uninterrupted; a real SIGTERM after train step 7,
    which must log the preempt line and leave a checkpoint at (0, 7);
    ``--resume true`` from it. The resumed run's parameters, buffers and
    AdamW state must equal the uninterrupted run's bit for bit; where they do
    not, a second uninterrupted run gives the card's own spread, and the
    resumed run must lie within it. Ops torch calls nondeterministic are
    named."""
    import os
    import signal
    import warnings

    import torch

    from scouter_tpu_torch.train import cli
    from scouter_tpu_torch.train import loop as train_loop

    tree = os.path.join(tmp, "preempt_tree")
    write_cub_tree(tree, [(c, True) for c in range(1, 161)] + [(c, False) for c in range(1, 17)])
    flags = ["--preempt_save", "true", "--ckpt_async", "true"]
    make_step = train_loop.make_train_step

    def signalling_step(lam, **kw):  # the Trainer passes its mesh too
        step, calls = make_step(lam, **kw), []

        def wrapped(state, batch):
            result = step(state, batch)
            calls.append(1)
            if len(calls) == 7:
                os.kill(os.getpid(), signal.SIGTERM)
            return result
        return wrapped

    def run(name, extra=(), interrupt=False):
        out = os.path.join(tmp, name)
        train_loop.make_train_step = signalling_step if interrupt else make_step
        try:
            _, lines = run_cli(cli.main, tree_flags(tree, out) + flags + list(extra))
        finally:
            train_loop.make_train_step = make_step
        return os.path.join(out, "CUB200_use_slot_checkpoint.pth"), lines

    cudnn = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    t0 = time.monotonic()
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            plain_path, _ = run("preempt_plain")
            path, lines = run("preempt_resumed", interrupt=True)
            if "[preempt] checkpointed epoch 0 at batch 7; exiting" not in lines or \
                    not any(line.startswith("[preempt] caught signal") for line in lines):
                fail(f"the SIGTERM run did not log its preemption: {lines[-6:]}")
            _, payload = _state_tensors(path)
            if (payload["epoch"], payload.get("batch")) != (0, 7):
                fail(f"the preemption checkpoint is at ({payload['epoch']}, "
                     f"{payload.get('batch')}), expected (0, 7)")
            _, lines = run("preempt_resumed", ["--resume", "true"])
            if not any(line.endswith("at epoch 0, batch 7") for line in lines):
                fail(f"the resumed run did not report the cursor: {lines[:4]}")
            plain, _ = _state_tensors(plain_path)
            resumed, payload = _state_tensors(path)
            if "batch" in payload or [n for n, _ in plain] != [n for n, _ in resumed]:
                fail("the resumed run's epoch-end checkpoint is not the uninterrupted run's kind")
            gap = _largest_difference(plain, resumed)
            spread = None
            if gap:
                again, _ = _state_tensors(run("preempt_plain_again")[0])
                spread = _largest_difference(plain, again)
        nondeterministic = sorted({str(w.message).split(".")[0] for w in caught
                                   if "deterministic" in str(w.message)})
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = cudnn
    print(f"preempt: 3 runs of 10 train steps in {time.monotonic() - t0:.2f} s; SIGTERM after "
          f"step 7 checkpointed (0, 7); the resumed run's {len(resumed)} parameters, buffers "
          f"and AdamW tensors against the uninterrupted run's: largest difference {gap!r}"
          + (f", two uninterrupted runs {spread!r}" if spread is not None else " (bit for bit)")
          + f"; ops torch calls nondeterministic: {nondeterministic or 'none'}", flush=True)
    if gap and not gap <= spread:
        fail(f"the resumed run is {gap} from the uninterrupted one, beyond the card's own "
             f"spread between two uninterrupted runs, {spread}")


def phase_folder_explain(tree: str, out: str):
    """The explain CLI on the tree's checkpoint and its val image 0, a JPEG
    decoded by nvJPEG: K1 launches once, hist-free; image.png and a slot map
    and overlay per class (401 PNGs) read back without Pillow. Returns K1's
    launches in the CLI run."""
    import os

    import numpy as np
    import torch

    from scouter_tpu_torch.core.png import read_png
    from scouter_tpu_torch.data._decode import decode_jpeg
    from scouter_tpu_torch.explain import cli
    from scouter_tpu_torch.ops import slot_kernel

    fused = slot_kernel.xslot_iterations_fused
    run_dir = os.path.join(out, "explain")
    os.makedirs(run_dir)
    fused.launches = fused.hist_launches = 0
    decode_jpeg.decodes = 0
    cwd = os.getcwd()
    os.chdir(run_dir)  # the CLI writes to ./sloter_vis
    try:
        t0 = time.monotonic()
        path, lines = run_cli(cli.main, tree_flags(tree, out))
        torch.cuda.synchronize()
        seconds = time.monotonic() - t0
    finally:
        os.chdir(cwd)
    k1, k1_hist = fused.launches, fused.hist_launches
    vis_dir = os.path.join(run_dir, "sloter_vis")
    names = sorted(os.listdir(vis_dir))
    pngs = {name: read_png(os.path.join(vis_dir, name)) for name in names}
    print(f"explain on the tree: CLI {seconds:.2f} s, restored {os.path.basename(path)}; "
          f"xslot_fwd launches {k1} (hist {k1_hist}); nvJPEG decodes {decode_jpeg.decodes}; "
          f"{len(pngs)} PNGs read back", flush=True)
    if (k1, k1_hist) != (1, 0):
        fail(f"explain on the tree: xslot_fwd launches {k1} (hist {k1_hist}), expected 1 "
             "hist-free")
    if decode_jpeg.decodes != 1:
        fail(f"explain on the tree: {decode_jpeg.decodes} nvJPEG decodes for its one JPEG")
    want = (["image.png"] + [f"slot_{i}.png" for i in range(200)]
            + [f"slot_mask_{i}.png" for i in range(200)])
    if names != sorted(want) or pngs["image.png"].shape != (260, 260, 3) or \
            pngs["slot_0.png"].shape != (9, 9) or pngs["slot_mask_0.png"].shape != (260, 260, 4):
        fail(f"explain on the tree wrote {len(names)} files; image.png "
             f"{pngs.get('image.png', np.zeros(0)).shape}")
    if "PIL" in sys.modules:
        fail("Pillow was imported on the card's explain path")
    return k1


def phase_folder_serve(out: str):
    """The HTTP server on the card with the tree's checkpoint answers a
    JPEG body (decoded by nvJPEG) and a PNG body; the PNG body's logits equal
    those of a ``.npy`` body that holds the same staged pixels."""
    import io
    import os

    import numpy as np
    import torch

    from scouter_tpu_torch.core import ScouterConfig
    from scouter_tpu_torch.data._decode import decode_file, decode_jpeg
    from scouter_tpu_torch.serve import InferenceEngine
    from scouter_tpu_torch.serve.server import load_state_dict, make_server

    cfg = ScouterConfig(**CUB).replace(device="cuda", output_dir=out)
    state_dict, source = load_state_dict(cfg)
    if source != os.path.join(out, "CUB200_use_slot_checkpoint.pth"):
        fail(f"the server restored {source}")
    npy = io.BytesIO()
    np.save(npy, decode_file(str(FIXTURES / FIXTURE_PNGS[0]), 260, "cpu").numpy())
    bodies = {"jpeg": (FIXTURES / FIXTURE_JPEGS[0]).read_bytes(),
              "png": (FIXTURES / FIXTURE_PNGS[0]).read_bytes(), "npy": npy.getvalue()}
    decode_jpeg.decodes = 0
    with InferenceEngine(cfg, state_dict, buckets=(1,), device="cuda") as eng:
        server = make_server(eng, cfg.img_size, 3, ("127.0.0.1", 0))
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            url = f"http://127.0.0.1:{server.server_address[1]}/predict"
            logits = {k: np.asarray(post(url, body)["logits"]) for k, body in bodies.items()}
        finally:
            server.shutdown()
            server.server_close()
            thread.join()
    torch.cuda.synchronize()
    for k, v in logits.items():
        if v.shape != (200,) or not np.isfinite(v).all():
            fail(f"served {k} body: logits {v.shape}")
    same = np.array_equal(logits["png"], logits["npy"])
    print(f"serve on the tree's checkpoint: a JPEG body (nvJPEG decodes "
          f"{decode_jpeg.decodes}), a PNG body and a .npy body of the PNG's staged pixels "
          f"answered; PNG and .npy logits equal: {same} (largest difference "
          f"{float(np.abs(logits['png'] - logits['npy']).max())!r})", flush=True)
    if decode_jpeg.decodes != 1 or not same:
        fail("serve on the tree: the JPEG body was not decoded by nvJPEG, or the PNG body's "
             "logits differ from the .npy body's")


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
    # the backbone's last BatchNorm in the state dict's order (the flagship's
    # layer4.1.bn3)
    last_bn = [k[:-len(".running_mean")] for k in init if k.startswith("backbone.")
               and k.endswith(".running_mean")][-1]
    names = ("slot.gru.weight_ih_l0", "conv1x1.weight", f"{last_bn}.running_mean",
             f"{last_bn}.running_var")
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
    print(f"train step gpu vs cpu {cfg.model} (batch 4): loss {lg:.6f} vs {lc:.6f}; max|d| "
          f"after the "
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
    print(f"train throughput {cfg.model} f32 bs={bs}: {bs / dt:.1f} img/s "
          f"({dt * 1e3:.2f} ms/step) on {card}", flush=True)
    return bs / dt


# phase 15: one full-depth representative per mechanism of the ResNet zoo
# (name, backbone kwargs), card against CPU at 224 px, batch 2
ZOO = (("resnet50", {}), ("resnext50_32x4d", {}), ("seresnext26d_32x4d", {}),
       ("seresnext26t_32x4d", {}), ("seresnext26tn_32x4d", {}), ("ecaresnet50d_pruned", {}),
       ("res2net50_26w_4s", {}), ("skresnet18", {}), ("skresnext50_32x4d", {}),
       ("resnetblur50", {}), ("gluon_senet154", {}), ("resnet50", {"output_stride": 16}),
       ("resnest26d", {"output_stride": 8}), ("resnet18", {"s2d_stem": True}))
ZOO_BAR = 1e-3  # max|d| over max(1, max|CPU|), logits and features


def phase_zoo_gpu_vs_cpu(zoo=ZOO, seed: int = 100, relative: bool = False):
    """Each representative of ``zoo`` with the same seeded weights
    (``init_weights``) on the card and on the CPU, eval mode, one seeded
    batch of 2 at 224 px: features and logits within ZOO_BAR of the CPU's
    scale, max(1, max|CPU|), or with ``relative`` max|CPU| itself (at init
    an eval forward of the EfficientNet family, whose blocks end without an
    act and whose BatchNorms hold mean 0 and variance 1, shrinks its map
    block by block, to ~1e-18 at the head, where a floor of 1 would hold
    nothing). On the CPU the logits are the model's own head on its
    features (``forward_head``, the forward's head code), to run each deep
    net once there."""
    import numpy as np
    import torch

    from scouter_tpu_torch.models import create_model, init_weights

    x = torch.from_numpy(np.random.RandomState(21).randn(2, 3, 224, 224).astype(np.float32))
    results = {}
    for i, (name, kw) in enumerate(zoo):
        label = name + "".join(f" {k}={v}" for k, v in kw.items())
        t0 = time.monotonic()
        cpu = create_model(name, **kw)
        init_weights(cpu, torch.Generator().manual_seed(seed + i))
        cpu.eval()
        gpu = create_model(name, **kw)
        gpu.load_state_dict(cpu.state_dict())
        gpu = gpu.cuda().eval()
        with torch.no_grad():
            f_cpu = cpu(x, features_only=True)
            l_cpu = cpu.forward_head(f_cpu)
            f_gpu = gpu(x.cuda(), features_only=True).cpu()
            l_gpu = gpu(x.cuda()).cpu()
        errs = {}
        for what, got, want in (("features", f_gpu, f_cpu), ("logits", l_gpu, l_cpu)):
            if got.shape != want.shape or not torch.isfinite(got).all():
                fail(f"zoo {label}: {what} of shape {tuple(got.shape)} on the card, "
                     f"{tuple(want.shape)} on the CPU, or not finite")
            scale = want.abs().max().item()
            scale = max(scale, 1e-30) if relative else max(1.0, scale)
            errs[what] = (got - want).abs().max().item() / scale
        print(f"zoo {label}: features {tuple(f_gpu.shape)} (max|CPU| "
              f"{f_cpu.abs().max().item():.3e}), card vs CPU max|d| / "
              f"{'max|CPU|' if relative else 'max(1, max|CPU|)'}: features "
              f"{errs['features']:.3e}, logits {errs['logits']:.3e} (bar {ZOO_BAR}); "
              f"{time.monotonic() - t0:.1f} s", flush=True)
        if max(errs.values()) > ZOO_BAR:
            fail(f"zoo {label}: the card differs from the CPU by {errs}")
        results[label] = errs
        del cpu, gpu
    return results


def phase_zoo_explain(tmp: str, cfg):
    """The explain CLI on ``cfg.model``'s checkpoint that phase_train wrote:
    K1 once, hist-free, K2 never, 1 + 2 x classes PNGs."""
    import os

    import torch

    from scouter_tpu_torch.explain import cli
    from scouter_tpu_torch.ops import render_kernel

    run_dir = os.path.join(tmp, "explain")
    os.makedirs(run_dir)
    k1_counts(reset=True)
    render_kernel.render_heatmaps_fused.launches = 0
    cwd = os.getcwd()
    os.chdir(run_dir)
    try:
        path, lines = run_cli(cli.main, flagship_flags(tmp, cfg.model, cfg.channel,
                                                       cfg.img_size))
    finally:
        os.chdir(cwd)
    torch.cuda.synchronize()
    counts = k1_counts()
    pngs = sorted(f for f in os.listdir(os.path.join(run_dir, "sloter_vis"))
                  if f.endswith(".png"))
    print(f"explain {cfg.model}: restored {os.path.basename(path)}, predicted {lines[-1]}, "
          f"{len(pngs)} PNGs; xslot_fwd launches {counts['launches']} (hist "
          f"{counts['hist_launches']}), render_heatmaps launches "
          f"{render_kernel.render_heatmaps_fused.launches}", flush=True)
    if counts["launches"] != 1 or counts["hist_launches"]:
        fail(f"explain {cfg.model}: K1 counts {counts}, expected one hist-free launch")
    if render_kernel.render_heatmaps_fused.launches:
        fail(f"explain {cfg.model}: the CLI launched K2")
    if len(pngs) != 1 + 2 * cfg.num_classes or int(lines[-1]) not in range(cfg.num_classes):
        fail(f"explain {cfg.model}: {len(pngs)} PNGs, prediction {lines[-1]!r}")
    return counts["launches"]


STEP_GRAD_NORM_BAR = 0.1  # ||g_card - g_cpu|| / ||g_cpu|| for each parameter


def recorded_k1(fwd_calls, bwd_calls):
    """A context in which every K1 forward and backward launch is recorded,
    its inputs and outputs cloned, into ``fwd_calls`` and ``bwd_calls``."""
    import contextlib

    import torch

    from scouter_tpu_torch.ops import slot_kernel

    launch, launch_bwd = slot_kernel._launch, slot_kernel._launch_bwd

    def recorded_launch(*args, **kw):
        out = launch(*args, **kw)
        fwd_calls.append(([a.clone() if torch.is_tensor(a) else a for a in args],
                          [o.clone() for o in out]))
        return out

    def recorded_launch_bwd(*args):
        out = launch_bwd(*args)
        bwd_calls.append(([a.clone() for a in args], [g.clone() for g in out]))
        return out

    @contextlib.contextmanager
    def recording():
        slot_kernel._launch, slot_kernel._launch_bwd = recorded_launch, recorded_launch_bwd
        try:
            yield
        finally:
            slot_kernel._launch, slot_kernel._launch_bwd = launch, launch_bwd

    return recording()


def phase_step_grads(cfg, b, map_side, seed, backbone_kwargs=None):
    """One train step of ``cfg``'s slot model at batch ``b`` on the card (f32),
    on the CPU (f32) and on the CPU in float64, from the same weights and
    batch (cuDNN deterministic); on the card K1's counts zeroed just before
    the step and read just after it, and its forward and backward calls
    recorded. Held: the loss and the BatchNorm statistics within 1e-3;
    every parameter's gradient, as the step leaves it before the
    optimizer's update, within ``STEP_GRAD_NORM_BAR`` of the CPU's in norm;
    the slot map ``map_side`` x ``map_side`` on both. At random weights the step is
    ill-conditioned (the renorm has no epsilon, and the error grows on its
    way down the backbone): the CPU's f32 gradients lie several percent of
    a tensor's max|g| from the same step in float64, which is printed
    beside the card's figures (the witness), so no per-element bar of 1e-3
    holds. Returns (the card's K1 counts, its recorded forward calls, its
    recorded backward calls)."""
    import numpy as np
    import torch

    from scouter_tpu_torch.models import build_slot_model
    from scouter_tpu_torch.train import create_train_state, make_train_step

    cfgb = cfg.replace(batch_size=b)
    init = build_slot_model(cfgb, device="cpu", backbone_kwargs=backbone_kwargs).state_dict()
    rng = np.random.RandomState(seed)
    images = torch.from_numpy(rng.randn(b, 3, cfg.img_size, cfg.img_size).astype(np.float32))
    labels = torch.from_numpy(rng.randint(0, cfg.num_classes, b))
    results, counts, fwd_calls, bwd_calls = {}, None, [], []
    torch.backends.cudnn.deterministic = True
    try:
        for dev, dtype in (("cuda", torch.float32), ("cpu", torch.float32),
                           ("cpu", torch.float64)):
            model = build_slot_model(cfgb, fused_slot=True, device=dev,
                                     backbone_kwargs=backbone_kwargs)
            model.load_state_dict(init)
            model.to(dtype)
            state = create_train_state(model, cfg.lr)
            step = make_train_step(cfg.lambda_value)
            k1_counts(reset=True)
            with recorded_k1(fwd_calls, bwd_calls):
                _, m = step(state, {"image": images.to(dev, dtype), "label": labels.to(dev)})
            if dtype == torch.float64:
                exact_grads = {k: p.grad for k, p in model.named_parameters()
                               if p.grad is not None}
                continue
            if dev == "cuda":
                torch.cuda.synchronize()
                counts = k1_counts()
            grads = {k: p.grad.cpu() for k, p in model.named_parameters() if p.grad is not None}
            stats = {k: t.cpu() for k, t in model.state_dict().items()
                     if k.endswith(("running_mean", "running_var"))}
            with torch.no_grad():
                attn_n = model.eval()(images[:1].to(dev, dtype))["attn"].shape[-1]
            results[dev] = (m["loss"].item(), grads, stats, attn_n)
    finally:
        torch.backends.cudnn.deterministic = False
    (lg, gg, sg, n_gpu), (lc, gc, sc, n_cpu) = results["cuda"], results["cpu"]
    what = f"{cfg.model} {json.dumps(backbone_kwargs or {})} train step (batch {b})"
    if (n_gpu, n_cpu) != (map_side ** 2, map_side ** 2):
        fail(f"{what} gave N={n_gpu} on the card and {n_cpu} on the CPU, not {map_side ** 2}")
    if set(gg) != set(gc) or not any(k.startswith("slot.") for k in gc):
        fail(f"{what} left gradients for {len(gg)} parameters on the card and "
             f"{len(gc)} on the CPU")
    by_max = {k: ((gg[k] - gc[k]).abs().max() / gc[k].abs().max()).item() for k in gc}
    by_norm = {k: ((gg[k] - gc[k]).norm() / gc[k].norm()).item() for k in gc}
    cpu_by_max = max(((gc[k].double() - g).abs().max() / g.abs().max()).item()
                     for k, g in exact_grads.items())
    cpu_by_norm = max(((gc[k].double() - g).norm() / g.norm()).item()
                      for k, g in exact_grads.items())
    card_by_norm = max(((gg[k].double() - g).norm() / g.norm()).item()
                       for k, g in exact_grads.items())
    head = [k for k in gc if not k.startswith("backbone.")]
    stat_err = max((sg[k] - sc[k]).abs().max().item() for k in sc)
    worst = max(by_norm, key=by_norm.get)
    print(f"{what}, N={n_gpu}: loss {lg:.6f} on the card vs {lc:.6f} on the CPU; {len(gc)} "
          f"gradients card vs CPU, ||d|| / ||g|| worst {by_norm[worst]:.3e} ({worst}; bar "
          f"{STEP_GRAD_NORM_BAR}), max|d| / max|g| worst {max(by_max.values()):.3e}, in the "
          f"slot head and conv1x1 {max(by_max[k] for k in head):.3e} (from the CPU's float64 "
          f"run, worst of a norm: the card's {card_by_norm:.3e}, the CPU's f32 "
          f"{cpu_by_norm:.3e}; the CPU's f32 {cpu_by_max:.3e} of a max|g|); BatchNorm "
          f"statistics max|d| {stat_err:.3e} (bar rtol/atol 1e-3); K1 in the card's step "
          f"{json.dumps(counts)}", flush=True)
    if not np.isclose(lg, lc, rtol=1e-3, atol=1e-3):
        fail(f"{what}: loss on the card {lg} differs from the CPU's {lc}")
    if by_norm[worst] > STEP_GRAD_NORM_BAR:
        fail(f"{what}: {worst}'s gradient differs between card and CPU by "
             f"{by_norm[worst]:.3e} of its norm")
    for k in sc:
        if not torch.allclose(sg[k], sc[k], rtol=1e-3, atol=1e-3):
            fail(f"{what}: {k} after the step differs between card and CPU")
    if any(a[0].device.type != "cuda" for a, _ in fwd_calls + bwd_calls):
        fail(f"{what}: K1 was recorded launching on CPU tensors")
    return counts, fwd_calls, bwd_calls


def phase_zoo_os16(cfg):
    """``cfg``'s slot model built with ``backbone_kwargs={"output_stride":
    16}`` (N = 196): one train step at batch 4 on the card and on the CPU
    from the same weights and batch, held by ``phase_step_grads``; the
    card's K1 counts in that step (hist 1, the backward's tiled route 1, a
    cluster 0); the tiled route's call inside the card's step, on the
    residuals and cotangents the step gave it, against ``xslot_bwd_ref`` to
    chip_smoke's gradient bar. Then the tiled route's launches in one call
    (``profiled_launches``) held to ``TiledPlan.launches``. Returns (the
    step's K1 counts, launches a call)."""
    import torch

    from scouter_tpu_torch.ops import slot_kernel

    b, s = 4, cfg.slots_per_class * cfg.num_classes
    counts, _, calls = phase_step_grads(cfg, b, 14, seed=22,
                                        backbone_kwargs={"output_stride": 16})
    if (counts["hist_launches"], counts["bwd_tiled_launches"], counts["bwd_launches"]) != (
            1, 1, 0):
        fail(f"the OS16 train step's K1 counts {counts}: expected hist 1, tiled backward 1, "
             "cluster 0")
    (plan,) = check_tiled_plans(((b, 196, s, cfg.hidden_dim),)).values()
    ((res, got),) = calls  # the card's call: the CPU runs the plain version
    if tuple(res[6].shape) != (b, 3, s, cfg.hidden_dim):
        fail(f"K1's backward in the OS16 step saw hist {tuple(res[6].shape)}")
    with torch.no_grad():
        want = slot_kernel.xslot_bwd_ref(*res)
        exact = slot_kernel.xslot_bwd_ref(*(t.double() for t in res))
    check_grads("xslot_bwd tiled route in the OS16 step vs xslot_bwd_ref,", b, 196, s,
                ("k", "v", "initial_slots", "w_ih", "w_hh", "b_ih", "b_hh"), got, want, exact)
    with torch.no_grad():
        per_call = profiled_launches(lambda: slot_kernel._launch_bwd(*res))
    print(f"xslot_bwd tiled route at ({b}, 196, {s}), the OS16 step's shape: {per_call} "
          f"launches in one call, graph nodes held to torch.profiler's launch calls "
          f"(TiledPlan.launches: {plan.launches(3)})", flush=True)
    if per_call != plan.launches(3):
        fail(f"the tiled route made {per_call} launches at the OS16 shape, the plan says "
             f"{plan.launches(3)}")
    return counts, per_call


def phase_zoo_os8_limit(cfg):
    """The slot model at output stride 8 reaches N = 28 x 28 = 784 at 224 px,
    past K1's forward reach at S=30 (N=343, ROADMAP Queue C): on the card
    its forward raises ValueError, where JAX's trains on the jnp path. The
    backbone itself runs at OS8 (phase 15's zoo)."""
    import torch

    from scouter_tpu_torch.models import build_slot_model

    model = build_slot_model(cfg.replace(batch_size=1), fused_slot=True, device="cuda",
                             backbone_kwargs={"output_stride": 8})
    x = torch.zeros(1, 3, cfg.img_size, cfg.img_size, device="cuda")
    try:
        with torch.no_grad():
            model(x)
    except ValueError as exc:
        print(f"{cfg.model} output_stride 8 slot model (N=784): K1 raises as documented: "
              f"{exc}", flush=True)
        return
    fail(f"{cfg.model} at output stride 8 (N=784) ran K1's forward past its documented reach")


def phase_zoo(card: str):
    """Phase 15: the ResNet zoo, and the flagship's config on resnet50 through
    the normal entry points. Returns what the kernels line carries."""
    import tempfile

    from scouter_tpu_torch.core import ScouterConfig
    from scouter_tpu_torch.models import build_slot_model

    t0 = time.monotonic()
    zoo = phase_zoo_gpu_vs_cpu()
    cfg = ScouterConfig(**FLAGSHIP).replace(model="resnet50")
    state_dict = build_slot_model(cfg, device="cpu").state_dict()
    serve_launches = phase_serve(cfg, state_dict)
    phase_gpu_vs_cpu(cfg, state_dict)
    serve_rates = phase_throughput(cfg, state_dict, card)
    with tempfile.TemporaryDirectory() as tmp:
        k1_counts(reset=True)
        launches, bwd_launches = phase_train(tmp, model=cfg.model)
        tiled = k1_counts()["bwd_tiled_launches"]
        if tiled:
            fail(f"{cfg.model} training took K1's tiled backward {tiled} times; (70, 49, 30) "
                 "runs on a cluster")
        explain_launches = phase_zoo_explain(tmp, cfg)
    train_rate = phase_train_throughput(cfg, card)
    os16_counts, os16_per_call = phase_zoo_os16(cfg)
    phase_zoo_os8_limit(cfg)
    seconds = time.monotonic() - t0
    summary = dict(zoo_max_rel_err=max(max(e.values()) for e in zoo.values()),
                   serve_img_per_s=serve_rates, train_img_per_s=train_rate)
    print(json.dumps({"resnet50_xslot": summary}), flush=True)
    print(f"phase 15 (zoo, resnet50 + xSlot) took {seconds:.1f} s", flush=True)
    return dict(serve_launches=serve_launches, train_launches=launches,
                bwd_launches=bwd_launches, explain_launches=explain_launches,
                os16_tiled_launches=os16_counts["bwd_tiled_launches"],
                os16_hist_launches=os16_counts["hist_launches"],
                os16_launches_per_call=os16_per_call)


# phase 16: the XAI baseline suite at the width README.md:96-97 documents
XAI_FLAGS = ["--dataset", "ImageNet", "--model", "resnest26d", "--num_classes", "10",
             "--img_size", "260", "--use_slot", "false", "--pre_trained", "false"]
XAI_CLASSES = 10
XAI_DEFAULT_METHODS = ("cam", "gradcam", "gradcampp", "smooth_gradcampp", "scorecam",
                       "gradient", "guided_backprop", "rise", "extremal", "igos")
# SS-CAM's and IS-CAM's samples on the card here (their defaults: 35 and 10)
XAI_REDUCED_SAMPLES = {"sscam": 4, "isscam": 3}
# card against CPU, as the CPU tests hold the port to JAX: single-shot and
# masked-rescoring maps within 1e-4 of the map's scale, iterative 1e-3. At
# random weights a deep net's ReLU gates and max-pool choices near a tie
# flip between any two f32 summation orders, and a gradient map moves with
# them at the pixels they feed (a VGG16 input gradient by 4.6e-2 of its
# scale for an input moved by 1e-5, on the CPU). A map past its bar is held
# to the CPU's float64 run instead (the card no further from it than
# XAI_F64_FACTOR x the CPU's own f32), or else, where the CPU's f32 happens
# to sit on the float64 map, in norm: ||card - CPU|| within XAI_NORM_BAR of
# ||CPU||, the pixels a flipped gate moves being few
XAI_SINGLE_SHOT_BAR = 1e-4
XAI_ITERATIVE_BAR = 1e-3
XAI_F64_FACTOR = 2.0
XAI_NORM_BAR = 1e-2
POINTING_IMAGES = 16


def xai_flags(tmp: str):
    import os

    return ["--device", "cuda"] + XAI_FLAGS + [
        "--batch_size", "70", "--dataset_dir", os.path.join(tmp, "no_dataset"),
        "--output_dir", tmp]


def kernel_launches(reset: bool = False):
    """K1's counters and K2's launches, zeroed first with ``reset``."""
    from scouter_tpu_torch.ops import render_kernel

    if reset:
        render_kernel.render_heatmaps_fused.launches = 0
    return dict(k1_counts(reset), k2_launches=render_kernel.render_heatmaps_fused.launches)


def phase_xai_train(tmp: str):
    """(a) A no-slot resnest26d trained one epoch through the train CLI on
    the stand-in at 260 px, so that the comparison CLI restores a real
    checkpoint."""
    import math
    import os

    from scouter_tpu_torch.train import cli

    t0 = time.monotonic()
    _, lines = run_cli(cli.main, xai_flags(tmp) + ["--epochs", "1", "--lr_drop", "1"])
    metrics = logged_metrics(lines)
    if not all(math.isfinite(v) for vs in metrics.values() for v in vs):
        fail(f"no-slot training: metrics {metrics}")
    path = os.path.join(tmp, "ImageNet_no_slot_checkpoint.pth")
    if not os.path.isfile(path):
        fail(f"no-slot training wrote no {os.path.basename(path)} ({sorted(os.listdir(tmp))})")
    print(f"phase 16: no-slot resnest26d trained one epoch at 260 px in "
          f"{time.monotonic() - t0:.1f} s", flush=True)


def check_pngs(out_dir: str, names):
    import os

    import numpy as np

    from scouter_tpu_torch.core.png import read_png

    have = sorted(f for f in os.listdir(out_dir) if f.endswith(".png"))
    if have != sorted(names):
        fail(f"{out_dir}: PNGs {have}, expected {sorted(names)}")
    for name in names:
        img = read_png(os.path.join(out_dir, name))
        if img.shape != (260, 260, 4) or img.dtype != np.uint8:
            fail(f"{name}: {img.shape} {img.dtype}")


def phase_xai_cli(tmp: str, timings):
    """(b) The comparison CLI on the card from that checkpoint: the
    torchcam_vis method set with --fast over all 10 classes, then the
    captum_vis set (--methods deeplift); every PNG written, every map
    finite."""
    import os

    import numpy as np

    from scouter_tpu_torch.explain import compare_cli

    runs = {"torchcam_vis": (["--fast"], XAI_DEFAULT_METHODS),
            "captum_vis": (["--methods", "deeplift"], ("deeplift",))}
    for what, (extra, methods) in runs.items():
        out = os.path.join(tmp, what)
        seconds = {}
        t0 = time.monotonic()
        maps = compare_cli.main(xai_flags(tmp) + extra, out_dir=out, timings=seconds)
        wall = time.monotonic() - t0
        for m in methods:
            if sorted(maps.get(m, {})) != list(range(XAI_CLASSES)):
                fail(f"{what}: {m} mapped classes {sorted(maps.get(m, {}))}")
            bad = [c for c, s in maps[m].items() if not np.isfinite(s).all()]
            if bad:
                fail(f"{what}: {m} maps not finite for classes {bad}")
        check_pngs(out, [f"{m}_{c}.png" for m in methods for c in range(XAI_CLASSES)])
        timings.update({f"{m} (cli, {XAI_CLASSES} classes)": s for m, s in seconds.items()})
        print(f"phase 16 {what}: {len(methods)} methods x {XAI_CLASSES} classes, "
              f"{len(methods) * XAI_CLASSES} PNGs read back, {wall:.1f} s", flush=True)


def phase_xai_remaining(model, image, tmp: str, timings):
    """(c) The methods the two CLI runs leave out, on class 0: SS-CAM and
    IS-CAM (at XAI_REDUCED_SAMPLES), deconvnet, linear approximation, EBP
    and IBA through ``compare_methods``, contrastive EBP directly (the
    driver has no such method, as JAX's has none)."""
    import os

    import numpy as np
    import torch

    from scouter_tpu_torch.data import preprocess_batch
    from scouter_tpu_torch.explain import compare_cli
    from scouter_tpu_torch.explain.excitation import contrastive_excitation_backprop

    methods = ["sscam", "isscam", "deconvnet", "linear_approx", "excitation", "iba"]
    seconds = {}
    out = os.path.join(tmp, "remaining")
    maps = compare_cli.compare_methods(model, image, [0], out, img_size=260, methods=methods,
                                       num_samples=XAI_REDUCED_SAMPLES, timings=seconds)
    x = preprocess_batch(torch.as_tensor(image).cuda()[None], dataset="ImageNet",
                         img_size=260).permute(0, 3, 1, 2).contiguous()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cebp = contrastive_excitation_backprop(model, x, 0)
    torch.cuda.synchronize()
    seconds["contrastive_excitation"] = time.perf_counter() - t0
    if not torch.isfinite(cebp).all() or float(cebp.min()) < 0:
        fail("contrastive EBP: a map not finite or below 0")
    for m in methods:
        if not np.isfinite(maps[m][0]).all():
            fail(f"{m}: the map is not finite")
    check_pngs(out, [f"{m}_0.png" for m in methods])
    timings.update({f"{m} (1 class)": s for m, s in seconds.items()})
    print(f"phase 16 remaining methods on class 0: {', '.join(methods)}, contrastive EBP; "
          f"SS-CAM and IS-CAM at {XAI_REDUCED_SAMPLES} samples (defaults 35 and 10)",
          flush=True)


def max_rel(got, want) -> float:
    """max |got - want| over the reference map's scale (max |want|)."""
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


def held_to_cpu(name: str, fn, models, inputs, bar: float):
    """``fn(model, x)`` on the card against the CPU (``models``/``inputs``:
    card, CPU and a callable giving the CPU float64 model; card, CPU and
    float64 inputs). Within ``bar`` of the CPU map's scale, or else held to
    the float64 map (XAI_F64_FACTOR), or else in norm (XAI_NORM_BAR).
    Returns the distances, the card's map and the CPU's."""
    import torch

    got, want = fn(models[0], inputs[0]), fn(models[1], inputs[1])
    if tuple(got.shape) != tuple(want.shape) or not torch.isfinite(got).all():
        fail(f"{name}: card map {tuple(got.shape)} against the CPU's {tuple(want.shape)}, "
             "or not finite")
    err = {"card_vs_cpu": max_rel(got, want)}
    if err["card_vs_cpu"] <= bar:
        return err, got, want
    f64 = fn(models[2](), inputs[2])
    err.update(card_vs_f64=max_rel(got, f64), cpu_vs_f64=max_rel(want, f64))
    if err["card_vs_f64"] <= XAI_F64_FACTOR * err["cpu_vs_f64"]:
        return err, got, want
    a, b = got.detach().double().cpu(), want.detach().double()
    err["norm"] = float((a - b).norm() / b.norm().clamp_min(1e-300))
    if err["norm"] > XAI_NORM_BAR:
        fail(f"{name}: card vs CPU {err['card_vs_cpu']:.3e} of the map's scale (bar {bar}); "
             f"from float64 the card {err['card_vs_f64']:.3e}, the CPU's f32 "
             f"{err['cpu_vs_f64']:.3e} (factor {XAI_F64_FACTOR}); in norm {err['norm']:.3e} "
             f"(bar {XAI_NORM_BAR})")
    return err, got, want


def f64_copy(model):
    """A lazily made float64 CPU copy of ``model``."""
    import copy

    made = []

    def get():
        if not made:
            made.append(copy.deepcopy(model).cpu().double())
        return made[0]

    return get


def phase_xai_gpu_vs_cpu(model, image):
    """(d) Card against CPU on the same weights, image and draws: every
    single-shot method, RISE at 400 masks, extremal, IGOS and IBA at 2
    iterations."""
    import copy

    import torch

    from scouter_tpu_torch.data import preprocess_batch
    from scouter_tpu_torch.explain import backprop, cam, deeplift, excitation, extremal, iba
    from scouter_tpu_torch.explain.igos import gaussian_blur_baseline, integrated_mask
    from scouter_tpu_torch.explain.rise import rise

    cpu_model = copy.deepcopy(model).cpu()
    x_cpu = preprocess_batch(torch.as_tensor(image)[None], dataset="ImageNet",
                             img_size=260).permute(0, 3, 1, 2).contiguous()
    x_gpu = x_cpu.cuda()
    c = 3
    single = {
        "cam": lambda m, x: cam.cam(m, x, c, normalized=False),
        "gradcam": lambda m, x: cam.gradcam(m, x, c, normalized=False),
        "gradcampp": lambda m, x: cam.gradcampp(m, x, c, normalized=False),
        "smooth_gradcampp": lambda m, x: cam.smooth_gradcampp(m, x, c, normalized=False),
        "gradient": lambda m, x: backprop.gradient_saliency(m, x, c),
        "deconvnet": lambda m, x: backprop.deconvnet(m, x, c),
        "guided_backprop": lambda m, x: backprop.guided_backprop(m, x, c),
        "linear_approx": lambda m, x: backprop.linear_approx(m, x, c),
        "deeplift": lambda m, x: deeplift.layer_deeplift(m, x, c),
        "excitation": lambda m, x: excitation.excitation_backprop(m, x.abs(), c),
        "rise_400": lambda m, x: rise(m, x, 0, num_masks=400),
    }
    # contrastive EBP stage by stage: its map is the difference of two
    # nearly equal relevances at layer4 (the w and -w classifier), which the
    # CPU's own f32 holds to no better than ~1e-1 of the map's scale against
    # float64 at random weights (smoke-final, PR 12); each stage is held to
    # the CPU apart, the second fed the CPU's contrast, and the whole map's
    # distances are printed
    contrast = contrastive_relevances(cpu_model, x_cpu.abs(), c)
    contrast = contrast[0] - contrast[1]
    single["contrastive_excitation relevances"] = (
        lambda m, x: contrastive_relevances(m, x.abs(), c))
    single["contrastive_excitation propagation"] = (
        lambda m, x: contrastive_propagation(m, x.abs(), contrast))

    def iba_map(m, x):
        features, head, _ = cam.backbone_split(m)
        g = torch.Generator().manual_seed(1)
        batches = [x + 0.1 * torch.randn(x.shape, generator=g).to(x.device) for _ in range(4)]
        stats = iba.estimate_stats(features, batches)
        return iba.iba_analyze(
            features, lambda z: -torch.log_softmax(head(z), dim=1)[:, c].mean(), x, stats, 0,
            optimization_steps=2, out_shape=(260, 260))

    iterative = {
        "extremal_2": lambda m, x: extremal.extremal_perturbation(m, x, c, max_iter=2)[0],
        "igos_2": lambda m, x: integrated_mask(m, x, gaussian_blur_baseline(x), c, 0,
                                               max_iterations=2).upsampled,
        "iba_2": iba_map,
    }
    models = (model, cpu_model, f64_copy(cpu_model))
    inputs = (x_gpu, x_cpu, x_cpu.double())
    errors = {}
    for bar, table in ((XAI_SINGLE_SHOT_BAR, single), (XAI_ITERATIVE_BAR, iterative)):
        for name, fn in table.items():
            errors[name] = held_to_cpu(name, fn, models, inputs, bar)[0]
    maps = [excitation.contrastive_excitation_backprop(m(), v.abs(), c) for m, v in
            ((lambda: model, x_gpu), (lambda: cpu_model, x_cpu), (models[2], inputs[2]))]
    errors["contrastive_excitation (printed, not held)"] = dict(
        card_vs_cpu=max_rel(maps[0], maps[1]), card_vs_f64=max_rel(maps[0], maps[2]),
        cpu_vs_f64=max_rel(maps[1], maps[2]))
    print(json.dumps({"xai_card_vs_cpu": errors}), flush=True)
    return errors


def contrastive_relevances(model, x, c, saliency_layer="layer2", contrast_layer="layer4"):
    """Contrastive EBP's first stage: the relevances at ``contrast_layer``
    from the w and the -w classifier, stacked (``excitation.py``'s)."""
    import torch

    from scouter_tpu_torch.explain import excitation

    with torch.no_grad():
        feats_c = model(model(x, stop_after=saliency_layer), start_from=saliency_layer,
                        stop_after=contrast_layer)
    with excitation.ebp_rules():
        return torch.stack([excitation._grad(
            lambda f, s=sign: excitation._head_from(model, contrast_layer, s)(f)[0, c], feats_c)
            for sign in (1.0, -1.0)])


def contrastive_propagation(model, x, contrast, saliency_layer="layer2",
                            contrast_layer="layer4"):
    """Contrastive EBP's second stage: ``contrast`` propagated from
    ``contrast_layer`` to ``saliency_layer`` under the EBP rules, channel
    sum clamped at zero."""
    import torch

    from scouter_tpu_torch.explain import excitation

    with torch.no_grad():
        feats_s = model(x, stop_after=saliency_layer)
    weight = contrast.detach().to(feats_s.device, feats_s.dtype)
    with excitation.ebp_rules():
        g = excitation._grad(lambda f: (model(f, start_from=saliency_layer,
                                              stop_after=contrast_layer) * weight).sum(),
                             feats_s)
    return g[0].sum(dim=0).clamp_min(0.0)


def write_voc_tree(root: str):
    """A VOC-2007-like tree (Annotations, JPEGImages, ImageSets/Main/test.txt)
    of POINTING_IMAGES images: the JPEG fixtures and PNGs of one coloured
    blob on noise (examples/pointing_game_report.py's images), each with an
    XML box of its class, a few with a second (difficult) box. The PNGs keep
    the ``.jpg`` name of the layout: the readers go by content."""
    import os
    import shutil

    import numpy as np

    from scouter_tpu_torch.core.png import write_png
    from scouter_tpu_torch.explain.datasets import VOC_CLASSES

    for d in ("Annotations", "JPEGImages", os.path.join("ImageSets", "Main")):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    rng = np.random.RandomState(0)
    palette = np.stack([0.5 + 0.5 * np.cos(2 * np.pi * (np.arange(20) / 20 + sh))
                        for sh in (0.0, 1 / 3, 2 / 3)], axis=1)
    ids = []
    for k in range(POINTING_IMAGES):
        image_id = f"{k:06d}"
        ids.append(image_id)
        path = os.path.join(root, "JPEGImages", image_id + ".jpg")
        label = int(rng.randint(0, 20))
        if k % 2 == 0:
            src = FIXTURES / FIXTURE_JPEGS[(k // 2) % len(FIXTURE_JPEGS)]
            shutil.copyfile(src, path)
            w, h = (int(v) for v in src.stem.split("_")[-1].split("x"))
            x0, y0 = int(rng.randint(0, w - 80)), int(rng.randint(0, h - 80))
            box = (x0 + 1, y0 + 1, x0 + 80, y0 + 80)
        else:
            h = w = 224
            cy, cx = rng.randint(30, 194, 2)
            yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
            blob = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * 15.0 ** 2))
            img = rng.rand(h, w, 3) * 0.35 + blob[..., None] * palette[label]
            write_png(path, (np.clip(img, 0, 1) * 255).astype(np.uint8))
            box = (cx - 29, cy - 29, cx + 30, cy + 30)
        objs = [(VOC_CLASSES[label], 0, box)]
        if k % 5 == 0:
            objs.append((VOC_CLASSES[(label + 7) % 20], 1, (2, 3, w // 3, h // 2)))
        xml = "".join(
            f"<object><name>{name}</name><difficult>{d}</difficult><bndbox>"
            f"<xmin>{b[0]}</xmin><ymin>{b[1]}</ymin><xmax>{b[2]}</xmax><ymax>{b[3]}</ymax>"
            "</bndbox></object>" for name, d, b in objs)
        with open(os.path.join(root, "Annotations", image_id + ".xml"), "w") as f:
            f.write(f"<annotation><size><width>{w}</width><height>{h}</height></size>"
                    f"{xml}</annotation>")
    with open(os.path.join(root, "ImageSets", "Main", "test.txt"), "w") as f:
        f.write("\n".join(ids) + "\n")


def phase_xai_pointing(tmp: str, timings):
    """(e) The pointing game on the synthetic VOC tree: ``voc_dataset`` ->
    CaffeVGG16 and CaffeResNet50 (random init, 20 classes) ->
    ``run_pointing_benchmark`` with gradient saliency (both models) and EBP
    (ResNet50; JAX's VGG16 has no stage split to start EBP from) into one
    sqlite store; each map held to the CPU's from the same decoded pixels
    and weights."""
    import copy
    import os

    import torch

    from scouter_tpu_torch.explain import backprop, excitation
    from scouter_tpu_torch.explain.benchmark import ExperimentStore, run_pointing_benchmark
    from scouter_tpu_torch.explain.benchmark_models import get_model, get_transform
    from scouter_tpu_torch.explain._resize import resize_bilinear
    from scouter_tpu_torch.explain.datasets import voc_dataset
    from scouter_tpu_torch.explain.image_utils import imread
    from scouter_tpu_torch.explain.pointing_game import PointingGame, saliency_point

    root = os.path.join(tmp, "voc")
    write_voc_tree(root)
    store = ExperimentStore(os.path.join(tmp, "pointing.db"))
    transform = get_transform("voc", size=(224, 224))

    def gradient(model, x, c):
        return backprop._to_saliency(backprop._input_grad(model, x, c))

    def ebp(model, x, c):
        return excitation.excitation_backprop(model, x, c)

    summary, errors = {}, {}
    for arch, methods in (("vgg16", {"gradient": gradient}),
                          ("resnet50", {"gradient": gradient, "excitation_backprop": ebp})):
        cpu_model, _ = get_model(arch, "voc", device="cpu", seed=0)
        models = (copy.deepcopy(cpu_model).cuda(), cpu_model, f64_copy(cpu_model))
        for name, fn in methods.items():
            worst = []

            def saliency(path, c, fn=fn, name=name):
                pixels = imread(path, device="cuda")
                x = transform(pixels).permute(2, 0, 1)[None].contiguous()
                x_cpu = transform(pixels.cpu()).permute(2, 0, 1)[None].contiguous()
                inputs = (x, x_cpu, x_cpu.double())
                what = f"pointing {arch} {name} {path} class {c}"
                err, got, want = held_to_cpu(what, lambda m, v: fn(m, v, c), models, inputs,
                                             XAI_SINGLE_SHOT_BAR)
                if "norm" in err:
                    # the benchmark's outcome from the CPU's map, as it
                    # resizes and points the card's
                    mask = next(m for p, k, m in voc_dataset(root) if p == path and k == c)
                    game = PointingGame(20)
                    hits = [game.evaluate(mask.astype(bool), saliency_point(
                        resize_bilinear(s.detach().float().cpu(), mask.shape).numpy()))
                        for s in (got, want)]
                    err["hits"] = hits
                    if hits[0] != hits[1]:
                        fail(f"{what}: the card's map {'hits' if hits[0] > 0 else 'misses'}, "
                             f"the CPU's does not ({err})")
                worst.append(err)
                return got

            t0 = time.perf_counter()
            game = run_pointing_benchmark(saliency, voc_dataset(root), 20, store=store,
                                          series=arch, experiment=name)
            seconds = time.perf_counter() - t0
            rows = len(store.keys(arch, name))
            if rows != len(worst) or rows < POINTING_IMAGES:
                fail(f"pointing {arch} {name}: {rows} stored rows, {len(worst)} items")
            errors[f"{arch} {name}"] = {
                "card_vs_cpu": max(e["card_vs_cpu"] for e in worst),
                "held_to_f64": sum("card_vs_f64" in e and "norm" not in e for e in worst),
                "held_in_norm": [e for e in worst if "norm" in e]}
            summary[f"{arch} {name}"] = dict(items=rows, hits=int(game.hits.sum()),
                                             misses=int(game.misses.sum()),
                                             accuracy=game.accuracy)
            timings[f"pointing {arch} {name} ({rows} items, card and CPU)"] = seconds
    store.close()
    print(json.dumps({"pointing_game_random_init": summary,
                      "pointing_card_vs_cpu": errors}), flush=True)


def phase_xai(card: str):
    """Phase 16: the XAI baseline suite (``scouter_tpu_torch.explain``'s
    comparison CLI and pointing-game stack) on the card, at resnest26d, 260
    px, 10 classes, backbone only. Neither kernel runs on this path: their
    counts are zeroed before it and must read 0 after."""
    import os
    import tempfile

    from scouter_tpu_torch.core import ScouterConfig
    from scouter_tpu_torch.explain.compare_cli import build_backbone

    t0 = time.monotonic()
    timings = {}
    kernel_launches(reset=True)
    with tempfile.TemporaryDirectory() as tmp:
        phase_xai_train(tmp)
        phase_xai_cli(tmp, timings)
        cfg = ScouterConfig(model="resnest26d", dataset="ImageNet", num_classes=10,
                            img_size=260, use_slot=False, output_dir=tmp, device="cuda")
        model, path = build_backbone(cfg)
        if path is None:
            fail("phase 16: the comparison CLI's checkpoint is gone")
        from scouter_tpu_torch.data import select_dataset

        image = select_dataset(cfg, train=False).images[0]
        phase_xai_remaining(model, image, tmp, timings)
        phase_xai_gpu_vs_cpu(model, image)
        phase_xai_pointing(tmp, timings)
    counts = kernel_launches()
    if any(counts.values()):
        fail(f"phase 16 launched a kernel: {counts}")
    for mod in ("PIL", "matplotlib"):
        if mod in sys.modules:
            fail(f"phase 16 imported {mod}")
    print(json.dumps({"xai_seconds": {k: round(v, 4) for k, v in timings.items()},
                      "card": card}), flush=True)
    print(f"phase 16 (XAI suite) took {time.monotonic() - t0:.1f} s; K1 and K2 launched "
          f"0 times; neither Pillow nor matplotlib imported", flush=True)
    return 0


# phase 17: the second backbone slice, one full-depth representative per
# mechanism (name, backbone kwargs), card against CPU at 224 px, batch 2
ZOO2 = (("efficientnet_b0", {}), ("tf_efficientnet_b0", {}), ("efficientnet_es", {}),
        ("efficientnet_cc_b0_4e", {}), ("mixnet_m", {}), ("mobilenetv3_large_100", {}),
        ("efficientnet_b2_pruned", {}), ("regnety_032", {}), ("dla60_res2next", {}),
        ("ese_vovnet39b_evos", {}), ("ese_vovnet99b_iabn", {}), ("densenetblur121d", {}),
        ("hrnet_w18_small", {}), ("senet154", {}), ("resnet50", {"attn": "cbam"}))
# the flagship's config (10 classes x 3 slots, d=64, batch 70) on
# efficientnet_b2 at the reference CLI's 260 px (9 x 9: N=81) and on
# densenet121 there (8 x 8: N=64)
EFFNET_B2 = dict(FLAGSHIP, model="efficientnet_b2", channel=1408, img_size=260)
DENSENET121 = dict(FLAGSHIP, model="densenet121", channel=1024, img_size=260)


def hold_k1_calls(what, fwd_calls, bwd_calls, shape, d):
    """K1's forward (with hist) and cluster-backward calls that one train
    step recorded (``recorded_k1``), one of each at ``shape`` = (B, N, S):
    each held to its plain version on the same inputs to ``check_grads``'
    bar (PERF.md section 2: 1e-4 x max(1, max|ref|), else at most 2x the
    plain f32 version's distance from float64), then timed at that shape
    against its plain version and bound. Returns the figures for the
    kernels line."""
    import torch

    from scouter_tpu_torch.ops import slot_kernel

    if len(fwd_calls) != 1 or len(bwd_calls) != 1:
        fail(f"{what}: {len(fwd_calls)} forward and {len(bwd_calls)} backward K1 calls "
             "recorded, expected one of each")
    ((fargs, fout),), ((bargs, bout),) = fwd_calls, bwd_calls
    b, n, s = shape
    if tuple(fargs[0].shape) != (b, n, d) or fargs[2].shape[-2] != s:
        fail(f"{what} gave K1 k {tuple(fargs[0].shape)} and slots "
             f"{tuple(fargs[2].shape)}, not (B, N, S) = {shape} at d={d}")
    fwd_plan = check_plan("fwd", b, n, s, d, fargs[0].device)
    bwd_plan = check_plan("bwd", b, n, s, d, fargs[0].device)
    if bwd_plan.tiled:
        fail(f"K1's backward at ({b}, {n}, {s}) planned its tiled route")
    tensors, iters = fargs[:7], fargs[7]
    if len(fout) != 3:
        fail(f"K1's forward in {what} emitted no hist")
    with torch.no_grad():
        want = slot_kernel.xslot_fwd_ref(*tensors, iters=iters, emit_hist=True)
        exact = slot_kernel.xslot_fwd_ref(*(t.double() for t in tensors), iters=iters,
                                          emit_hist=True)
    fwd_err = check_grads(f"xslot_fwd in {what} vs xslot_fwd_ref,", b, n, s,
                          ("upd", "attn", "hist"), fout, want, exact)
    with torch.no_grad():
        want = slot_kernel.xslot_bwd_ref(*bargs)
        exact = slot_kernel.xslot_bwd_ref(*(t.double() for t in bargs))
    bwd_err = check_grads(f"xslot_bwd in {what} vs xslot_bwd_ref,", b, n, s,
                          ("k", "v", "initial_slots", "w_ih", "w_hh", "b_ih", "b_hh"),
                          bout, want, exact)
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: slot_kernel._launch(*tensors, iters, True), 50)
        fwd_plain_ms = cuda_ms(lambda: slot_kernel.xslot_fwd_ref(
            *tensors, iters=iters, emit_hist=True), 50)
        bwd_ms = cuda_ms(lambda: slot_kernel._launch_bwd(*bargs), 50)
        bwd_plain_ms = cuda_ms(lambda: slot_kernel.xslot_bwd_ref(*bargs), 50)
    fwd_bound, fwd_by = xslot_bound(b, n, s, d, hist_iters=iters)
    bwd_bound, bwd_by = xslot_bwd_bound(b, n, s, d)
    print(f"K1 at ({b}, {n}, {s}) in {what}: forward with hist {fwd_ms:.5f} ms (plain "
          f"{fwd_plain_ms:.4f} ms, bound {fwd_bound:.6f} ms, {fwd_by}; cluster "
          f"{fwd_plan.cluster}), backward {bwd_ms:.5f} ms (plain {bwd_plain_ms:.4f} ms, "
          f"bound {bwd_bound:.6f} ms, {bwd_by}; cluster {bwd_plan.cluster})", flush=True)
    return {"fwd": {"shape": [b, n, s, d], "max_abs_err": fwd_err, "ms": fwd_ms,
                    "plain_ms": fwd_plain_ms, "bound_ms": fwd_bound, "bound_by": fwd_by,
                    "cluster": fwd_plan.cluster},
            "bwd": {"shape": [b, n, s, d], "max_abs_err": bwd_err, "ms": bwd_ms,
                    "plain_ms": bwd_plain_ms, "bound_ms": bwd_bound, "bound_by": bwd_by,
                    "cluster": bwd_plan.cluster}}


def phase_zoo2_k1_in_step(cfg, map_side: int):
    """One f32 train step of ``cfg``'s slot model on the card at its batch
    (70: K1 at (70, ``map_side``**2, 30)), K1's counts zeroed just before
    and read just after (forward with hist 1, backward on a cluster 1,
    tiled 0), its calls held and timed by ``hold_k1_calls``. Returns the
    figures for the kernels line."""
    import torch

    from scouter_tpu_torch.data import _synthetic_folder, preprocess_batch
    from scouter_tpu_torch.models import build_slot_model
    from scouter_tpu_torch.train import create_train_state, make_train_step

    b, s = cfg.batch_size, cfg.slots_per_class * cfg.num_classes
    ds = _synthetic_folder(cfg.dataset, cfg.num_classes, cfg.img_size, train=True)
    images = preprocess_batch(torch.from_numpy(ds.images[:b]).cuda(), dataset=cfg.dataset,
                              img_size=cfg.img_size).permute(0, 3, 1, 2).contiguous()
    batch = {"image": images, "label": torch.from_numpy(ds.labels[:b]).long().cuda()}
    state = create_train_state(build_slot_model(cfg, fused_slot=True, device="cuda"), cfg.lr)
    fwd_calls, bwd_calls = [], []
    k1_counts(reset=True)
    with recorded_k1(fwd_calls, bwd_calls):
        _, m = make_train_step(cfg.lambda_value)(state, batch)
        torch.cuda.synchronize()
    counts = k1_counts()
    if not torch.isfinite(m["loss"]):
        fail(f"{cfg.model} train step at batch {b}: loss {m['loss']}")
    if (counts["launches"], counts["hist_launches"], counts["bwd_launches"],
            counts["bwd_tiled_launches"]) != (1, 1, 1, 0):
        fail(f"{cfg.model} train step at batch {b}: K1 counts {counts}, expected the "
             "forward with hist once and the backward on a cluster once")
    return hold_k1_calls(f"the {cfg.model} train step", fwd_calls, bwd_calls,
                         (b, map_side ** 2, s), cfg.hidden_dim)


def phase_zoo2(card: str):
    """Phase 17: the second backbone slice. Its full-depth representatives
    card against CPU; the flagship's config on efficientnet_b2 at 260 px
    through the normal entry points (the engine and HTTP, card vs CPU
    logits, serving img/s in f32 and bf16, the train CLI for two epochs and
    a resumed third, the explain CLI, a train step card vs CPU, train
    img/s, K1's calls in a train step at (70, 81, 30) against their plain
    versions); densenet121 + xSlot (N=64) served, card vs CPU logits,
    serving and train img/s and a train step card vs CPU. Returns what the
    kernels line carries."""
    import tempfile

    from scouter_tpu_torch.core import ScouterConfig
    from scouter_tpu_torch.models import build_slot_model

    t0 = time.monotonic()
    zoo = phase_zoo_gpu_vs_cpu(ZOO2, seed=200, relative=True)
    cfg = ScouterConfig(**EFFNET_B2)
    state_dict = build_slot_model(cfg, device="cpu").state_dict()
    side = 9  # efficientnet_b2 at 260 px: N=81
    serve_launches = phase_serve(cfg, state_dict, map_side=side)
    phase_gpu_vs_cpu(cfg, state_dict, relative=True)
    serve_rates = phase_throughput(cfg, state_dict, card)
    with tempfile.TemporaryDirectory() as tmp:
        k1_counts(reset=True)
        launches, bwd_launches = phase_train(tmp, cfg.model, cfg.channel, cfg.img_size)
        tiled = k1_counts()["bwd_tiled_launches"]
        if tiled:
            fail(f"{cfg.model} training took K1's tiled backward {tiled} times; (70, 81, 30) "
                 "runs on a cluster")
        explain_launches = phase_zoo_explain(tmp, cfg)
    phase_train_gpu_vs_cpu(cfg)
    train_rate = phase_train_throughput(cfg, card)
    k1 = phase_zoo2_k1_in_step(cfg, map_side=side)

    dcfg = ScouterConfig(**DENSENET121)
    dense_sd = build_slot_model(dcfg, device="cpu").state_dict()
    dense_serve_launches = phase_serve(dcfg, dense_sd, map_side=8)
    phase_gpu_vs_cpu(dcfg, dense_sd, relative=True)
    dense_serve_rates = phase_throughput(dcfg, dense_sd, card)
    phase_train_gpu_vs_cpu(dcfg)
    dense_train_rate = phase_train_throughput(dcfg, card)
    seconds = time.monotonic() - t0
    print(json.dumps({"efficientnet_b2_xslot": dict(
        zoo_max_rel_err=max(max(e.values()) for e in zoo.values()),
        serve_img_per_s=serve_rates, train_img_per_s=train_rate),
        "densenet121_xslot": dict(serve_img_per_s=dense_serve_rates,
                                  train_img_per_s=dense_train_rate), "card": card}),
          flush=True)
    print(f"phase 17 (second backbone slice, efficientnet_b2 + xSlot) took {seconds:.1f} s",
          flush=True)
    return dict(serve_launches=serve_launches, train_launches=launches,
                bwd_launches=bwd_launches, explain_launches=explain_launches,
                dense_serve_launches=dense_serve_launches, k1=k1)


# phase 18: one full-depth representative per mechanism of the last ten
# families, card against CPU at 224 px, batch 2
ZOO3 = (("dpn68b", {}), ("dpn107", {}), ("tresnet_m", {}), ("tresnet_xl", {}),
        ("selecsls42b", {}), ("selecsls84", {}), ("inception_v3", {}), ("inception_v4", {}),
        ("inception_resnet_v2", {}), ("xception", {}), ("gluon_xception65", {}),
        ("gluon_xception71", {}), ("nasnetalarge", {}), ("pnasnet5large", {}))
# the flagship's config (10 classes x 3 slots, d=64, batch 70) on xception at
# its published 299 px (10 x 10: N=100) and on NASNet-A Large at its 331 px
# (11 x 11: N=121)
XCEPTION = dict(FLAGSHIP, model="xception", channel=2048, img_size=299)
NASNET = dict(FLAGSHIP, model="nasnetalarge", channel=4032, img_size=331)
NASNET_TRAIN_BATCH = 16  # fixed: NASNet-A Large's activations at 331 px are large


def phase_nasnet_train_rate(cfg, card: str):
    """NASNet-A Large + xSlot's f32 train img/s at NASNET_TRAIN_BATCH with
    the card's peak memory over those steps."""
    import torch

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rate = phase_train_throughput(cfg.replace(batch_size=NASNET_TRAIN_BATCH), card)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"train {cfg.model} bs={NASNET_TRAIN_BATCH}: {rate:.1f} img/s, "
          f"torch.cuda.max_memory_allocated {peak:.2f} GiB on {card}", flush=True)
    return rate, peak


def phase_zoo3_step(cfg, map_side, seed):
    """One train step of ``cfg``'s slot model at batch 4 on the card and on
    the CPU (``phase_step_grads``: the loss, the statistics and every
    parameter's gradient before the update, with the CPU's float64 run as
    the witness); the card's K1 counts in the step (forward with hist 1,
    backward on a cluster 1, tiled 0) and its two calls, at (4,
    ``map_side``**2, 30), held to their plain versions and timed by
    ``hold_k1_calls``. Returns (the counts, the calls' figures)."""
    b = 4
    counts, fwd_calls, bwd_calls = phase_step_grads(cfg, b, map_side, seed)
    if (counts["hist_launches"], counts["bwd_launches"],
            counts["bwd_tiled_launches"]) != (1, 1, 0):
        fail(f"{cfg.model}'s train step at batch {b} gave K1 counts {counts}, expected the "
             "forward with hist once and the backward on a cluster once")
    return counts, hold_k1_calls(f"the {cfg.model} train step at batch {b}", fwd_calls,
                                 bwd_calls, (b, map_side ** 2,
                                             cfg.slots_per_class * cfg.num_classes),
                                 cfg.hidden_dim)


def phase_zoo3(card: str):
    """Phase 18: the last ten backbone families. Their full-depth
    representatives card against CPU; the flagship's config on xception at
    299 px through the normal entry points (the engine and HTTP, card vs
    CPU logits, serving img/s in f32 and bf16, the train CLI for two epochs
    and a resumed third, the explain CLI, a train step at batch 4 card vs
    CPU with K1's calls at (4, 100, 30), train img/s, K1's calls in a train
    step at (70, 100, 30) against their plain versions); nasnetalarge +
    xSlot at 331 px (N=121) served, card vs CPU logits, serving img/s at
    batch 70, a train step at batch 4 card vs CPU with K1's calls at (4,
    121, 30) and train img/s at batch 16 with the card's peak memory. The
    batch-4 steps are ``phase_zoo3_step``'s. Returns what the kernels line
    carries."""
    import tempfile

    from scouter_tpu_torch.core import ScouterConfig
    from scouter_tpu_torch.models import build_slot_model

    t0 = time.monotonic()
    zoo = phase_zoo_gpu_vs_cpu(ZOO3, seed=300, relative=True)
    cfg = ScouterConfig(**XCEPTION)
    state_dict = build_slot_model(cfg, device="cpu").state_dict()
    side = 10  # xception at 299 px: N=100
    serve_launches = phase_serve(cfg, state_dict, map_side=side)
    phase_gpu_vs_cpu(cfg, state_dict, relative=True)
    serve_rates = phase_throughput(cfg, state_dict, card)
    with tempfile.TemporaryDirectory() as tmp:
        k1_counts(reset=True)
        launches, bwd_launches = phase_train(tmp, cfg.model, cfg.channel, cfg.img_size)
        tiled = k1_counts()["bwd_tiled_launches"]
        if tiled:
            fail(f"{cfg.model} training took K1's tiled backward {tiled} times; (70, 100, 30) "
                 "runs on a cluster")
        explain_launches = phase_zoo_explain(tmp, cfg)
    step_k1 = phase_zoo3_step(cfg, side, seed=18)[1]
    train_rate = phase_train_throughput(cfg, card)
    k1 = phase_zoo2_k1_in_step(cfg, map_side=side)

    ncfg = ScouterConfig(**NASNET)
    nasnet_sd = build_slot_model(ncfg, device="cpu").state_dict()
    nside = 11  # nasnetalarge at 331 px: N=121
    nasnet_serve_launches = phase_serve(ncfg, nasnet_sd, map_side=nside)
    phase_gpu_vs_cpu(ncfg, nasnet_sd, relative=True)
    nasnet_serve_rates = phase_throughput(ncfg, nasnet_sd, card)
    step_counts, nasnet_k1 = phase_zoo3_step(ncfg, nside, seed=19)
    nasnet_train_rate, nasnet_peak = phase_nasnet_train_rate(ncfg, card)
    seconds = time.monotonic() - t0
    print(json.dumps({"xception_xslot": dict(
        zoo_max_rel_err=max(max(e.values()) for e in zoo.values()),
        serve_img_per_s=serve_rates, train_img_per_s=train_rate),
        "nasnetalarge_xslot": dict(serve_img_per_s=nasnet_serve_rates,
                                   train_img_per_s_bs16=nasnet_train_rate,
                                   train_max_memory_allocated_gib=nasnet_peak),
        "card": card}), flush=True)
    print(f"phase 18 (last ten backbone families, xception + xSlot) took {seconds:.1f} s",
          flush=True)
    return dict(serve_launches=serve_launches, train_launches=launches,
                bwd_launches=bwd_launches, explain_launches=explain_launches,
                nasnet_serve_launches=nasnet_serve_launches,
                nasnet_step_launches=step_counts["launches"],
                nasnet_step_bwd_launches=step_counts["bwd_launches"], k1=k1,
                step_k1=step_k1, nasnet_k1=nasnet_k1)


# phase 19: the optimizer and scheduler factories, extra losses,
# AutoAugment/RandAugment, mixup and erasing, TF preprocessing, MNIST
# variants and the utils package, at the flagship's width
FACTORY_NAMES = ("sgd", "nesterov", "momentum", "adam", "adamw", "nadam", "radam", "rmsprop",
                 "rmsproptf", "novograd", "nvnovograd", "adadelta", "adagrad", "lamb", "lars",
                 "lookahead_adamw")
FACTORY_LR, FACTORY_WD = 1e-4, 0.01
FACTORY_BAR = 1e-6  # card vs the CPU optimizer, of max(1, max|p|)
EMA_BAR = 1e-6
AUG_LEVELS = (0, 5, 10)
AUG_SIZE, AUG_BATCH = 260, 70  # the CUB recipe's staging size, the flagship's batch
AUG_PIXEL_SHARE = 1e-3  # at most this share of an op's pixels may be 1 level off
RECIPE_STEPS = 10
# the CPU twin of the card's TfPreprocessTransform calls, in a child process:
# its JPEG decode is Pillow's, which this process never imports
TF_PRE_CPU = r"""
import sys, numpy as np
sys.path.insert(0, sys.argv[1])
from scouter_tpu_torch.data import TfPreprocessTransform
names, out = sys.argv[2].split(","), {}
for train in (False, True):
    t = TfPreprocessTransform(is_training=train, size=224, seed=0, device="cpu")
    for name in names:
        key = f"{int(train)}/{name}"
        out[key] = t(open(sys.argv[3] + "/" + name, "rb").read()).numpy()
        out[key + "/box"] = np.asarray(t.last_box)
np.savez(sys.argv[4], **out)
"""


def sync(dev: str) -> None:
    import torch

    if dev == "cuda":
        torch.cuda.synchronize()


def host_copy(t):
    """A CPU copy of ``t`` (``.cpu()`` would alias a CPU tensor)."""
    return t.detach().to("cpu", copy=True)


def flagship_batch(cfg, dev="cuda"):
    """The first ``cfg.batch_size`` images of the synthetic ImageNet stand-in,
    preprocessed, on the card (as ``phase_train_throughput``)."""
    import torch

    from scouter_tpu_torch.data import _synthetic_folder, preprocess_batch

    bs = cfg.batch_size
    ds = _synthetic_folder(cfg.dataset, cfg.num_classes, cfg.img_size, train=True)
    images = preprocess_batch(torch.from_numpy(ds.images[:bs]).to(dev), dataset=cfg.dataset,
                              img_size=cfg.img_size).permute(0, 3, 1, 2).contiguous()
    return {"image": images, "label": torch.from_numpy(ds.labels[:bs]).long().to(dev)}


def rel_err(got, want) -> float:
    """max|got - want| over max(1, max|want|), on the CPU."""
    got, want = got.detach().cpu().double(), want.detach().cpu().double()
    if got.numel() == 0:
        return 0.0
    return (got - want).abs().max().item() / max(1.0, want.abs().max().item())


def phase_factory_optimizers(cfg, batch, card: str, dev="cuda"):
    """Each factory optimizer in one ``make_train_step`` step from the same
    saved state; the card's updated parameters and optimizer state held to
    the port's CPU optimizer applied to the card's own pre-step parameters
    and gradients (FACTORY_BAR); then the optimizer's step alone timed on
    the card (5 calls, host clock between synchronizes)."""
    import torch

    from scouter_tpu_torch.models import build_slot_model
    from scouter_tpu_torch.train import TrainState, make_train_step
    from scouter_tpu_torch.train.optim_factory import create_optimizer

    model = build_slot_model(cfg, fused_slot=True, device=dev)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    step = make_train_step(cfg.lambda_value)
    errors, step_ms = {}, {}
    for name in FACTORY_NAMES:
        model.load_state_dict(init)
        params = dict(model.named_parameters())
        opt = create_optimizer(name, lr=FACTORY_LR, weight_decay=FACTORY_WD, params=params)
        pre = {k: host_copy(p) for k, p in params.items()}
        _, m = step(TrainState(model=model, optimizer=opt), batch)
        if not torch.isfinite(m["loss"]).item():
            fail(f"{name}: the train step's loss is not finite")
        cpu = {k: torch.nn.Parameter(v.clone()) for k, v in pre.items()}
        cpu_opt = create_optimizer(name, lr=FACTORY_LR, weight_decay=FACTORY_WD, params=cpu)
        for k, p in params.items():
            cpu[k].grad = p.grad.detach().cpu()
        cpu_opt.step()
        worst = (0.0, "")
        for k, p in params.items():
            worst = max(worst, (rel_err(p, cpu[k]), k))
            state, cpu_state = opt.state[p], cpu_opt.state[cpu[k]]
            if sorted(state) != sorted(cpu_state):
                fail(f"{name}: {k}'s optimizer state has {sorted(state)} on the card, "
                     f"{sorted(cpu_state)} on the CPU")
            for key, value in state.items():
                worst = max(worst, (rel_err(value, cpu_state[key]), f"{k} state {key}"))
        errors[name] = worst
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(5):
            opt.step()
        sync(dev)
        step_ms[name] = (time.perf_counter() - t0) / 5 * 1e3
    name, (err, where) = max(errors.items(), key=lambda kv: kv[1][0])
    print(f"factory optimizers in the flagship's train step, card vs the CPU optimizer on the "
          f"card's pre-step parameters and gradients: worst {name} ({where}) {err:.3e} of "
          f"max(1, max|p|) (bar {FACTORY_BAR:g}); each: "
          f"{json.dumps({n: float(f'{e:.3e}') for n, (e, _) in errors.items()})}", flush=True)
    if err > FACTORY_BAR:
        fail(f"{name}'s step on the card is {err:.3e} from the CPU optimizer's at {where}")
    print(f"optimizer step alone ({cfg.model} + xSlot, {len(params)} tensors, ms, host clock): "
          f"{json.dumps({n: round(v, 3) for n, v in step_ms.items()})} on {card}", flush=True)
    return step_ms


def phase_recipe(cfg, batch, tmp: str, card: str, dev="cuda"):
    """Ten nadam steps on one repeated batch with the utils package: the
    loss falls; ``ModelEma`` updated every step and held to a CPU replay of
    the same parameter sequence; ``CheckpointSaver(max_history=2)`` ranking
    the steps by ``evaluate_top1`` of an eval forward; ``update_summary``'s
    rows; ``Timer`` around each step; ``trace()`` around the last two steps,
    whose file must name K1's kernels."""
    import csv
    import glob
    import os
    import re

    import torch

    from scouter_tpu_torch.models import build_slot_model
    from scouter_tpu_torch.train import TrainState, make_train_step
    from scouter_tpu_torch.train.optim_factory import create_optimizer
    from scouter_tpu_torch.utils import (CheckpointSaver, ModelEma, Timer, evaluate_top1,
                                         trace, update_summary)

    model = build_slot_model(cfg, fused_slot=True, device=dev)
    params = dict(model.named_parameters())
    state = TrainState(model=model, optimizer=create_optimizer(
        "nadam", lr=FACTORY_LR, weight_decay=FACTORY_WD, params=params))
    ema = ModelEma(params, decay=0.9, device=dev)
    history = [{k: host_copy(p) for k, p in params.items()}]
    saver = CheckpointSaver(os.path.join(tmp, "ckpt"), max_history=2)
    summary = os.path.join(tmp, "summary.csv")
    timer = Timer(device=dev)
    step = make_train_step(cfg.lambda_value)
    losses, top1s = [], []

    def one_step(i):
        nonlocal state
        ema.decay = min(0.9, (1 + i) / (10 + i))  # a timm-style warmup: the decay moves
        with timer.measure():
            state, m = step(state, batch)
        ema.update(params)
        history.append({k: host_copy(p) for k, p in params.items()})
        model.eval()
        with torch.no_grad():
            top1 = evaluate_top1(model(batch["image"])["logits"], batch["label"]).item()
        losses.append(m["loss"].item())
        top1s.append(top1)
        saver.save_checkpoint({"step": i, "top1": top1, "model": model.state_dict()}, i, top1)
        update_summary(i, {"loss": losses[-1]}, {"top1": top1}, summary)

    for i in range(RECIPE_STEPS - 2):
        one_step(i)
    with trace(os.path.join(tmp, "trace")):
        for i in range(RECIPE_STEPS - 2, RECIPE_STEPS):
            one_step(i)
    print(f"nadam recipe, {RECIPE_STEPS} steps on one repeated batch of {cfg.batch_size}: loss "
          f"{', '.join(f'{v:.4f}' for v in losses)}; top-1 {top1s}; step {timer.mean * 1e3:.2f} "
          f"ms (Timer) on {card}", flush=True)
    if not losses[-1] < losses[0]:
        fail(f"the nadam recipe's loss did not fall: {losses[0]} -> {losses[-1]}")
    replay = ModelEma(history[0], decay=0.9, device="cpu")
    for i, p in enumerate(history[1:]):
        replay.decay = min(0.9, (1 + i) / (10 + i))
        replay.update(p)
    ema_err = max(rel_err(ema.params[k], replay.params[k]) for k in params)
    print(f"ModelEma on the card vs its CPU replay: {ema_err:.3e} (bar {EMA_BAR:g})", flush=True)
    if ema_err > EMA_BAR:
        fail(f"ModelEma on the card is {ema_err:.3e} from its CPU replay")
    kept = sorted(m for _, m in saver.checkpoint_files)
    files = sorted(os.path.basename(p) for p in glob.glob(os.path.join(tmp, "ckpt", "*.pth")))
    if (kept != sorted(top1s)[-2:] or files != sorted(
            [os.path.basename(p) for p, _ in saver.checkpoint_files] + ["model_best.pth"])):
        fail(f"CheckpointSaver kept {saver.checkpoint_files} ({files}) of top-1 {top1s}")
    best = torch.load(os.path.join(tmp, "ckpt", "model_best.pth"), weights_only=True)
    if (best["step"], saver.best_epoch) != (top1s.index(max(top1s)),) * 2:
        fail(f"model_best.pth holds step {best['step']}, the saver's best {saver.best_epoch}, "
             f"of top-1 {top1s}")
    with open(summary) as f:
        rows = list(csv.DictReader(f))
    if [int(r["epoch"]) for r in rows] != list(range(RECIPE_STEPS)) or list(rows[0]) != [
            "epoch", "train_loss", "eval_top1"]:
        fail(f"update_summary wrote {rows}")
    (trace_file,) = glob.glob(os.path.join(tmp, "trace", "*.pt.trace.json"))
    with open(trace_file) as f:
        events = json.load(f)["traceEvents"]
    kernels = sorted({m.group(0) for e in events if e.get("cat") == "kernel"
                      for m in [re.search(r"\w*xslot\w*", e.get("name", ""))] if m})
    ops = sorted({e["name"] for e in events if e.get("name", "").startswith("scouter_tpu_torch::")})
    print(f"trace() around two steps: K1's kernels {kernels}, its ops {ops}", flush=True)
    if not kernels:
        fail(f"the trace {trace_file} names none of K1's kernels")
    return model, dict(losses=losses, top1=top1s, step_ms=timer.mean * 1e3, ema_err=ema_err)


def staged_fixture_batch(dev: str):
    """AUG_BATCH images staged to AUG_SIZE from the committed fixtures
    (fixture k mod 8), uint8 (N, 3, H, W) on ``device``."""
    import torch

    from scouter_tpu_torch.data._decode import decode_file

    names = FIXTURE_JPEGS + FIXTURE_PNGS
    staged = [decode_file(str(FIXTURES / n), AUG_SIZE, dev).permute(2, 0, 1) for n in names]
    return torch.stack([staged[i % len(names)] for i in range(AUG_BATCH)])


def held_pixels(what: str, got, want, counts):
    """``got`` (card) equal to ``want`` (CPU), or at most 1 level off on at
    most AUG_PIXEL_SHARE of the pixels; the count goes into ``counts``."""
    diff = (got.cpu().int() - want.int()).abs()
    off = int((diff > 0).sum())
    counts[what] = off
    if diff.max().item() > 1 or off > AUG_PIXEL_SHARE * diff.numel():
        fail(f"{what}: the card is {diff.max().item()} levels from the CPU at {off} of "
             f"{diff.numel()} pixels")


def phase_augment(card: str, dev="cuda"):
    """Every op of ``_OPS`` on a batch of 70 fixtures staged to 260 px, each
    image with one of levels 0, 5, 10 and, for a signed op, one of both
    signs (every combination on some images), card vs CPU; AutoAugment
    'v0' and 'original' and RandAugment(2, 9) at seed 0 on the batch, card
    vs CPU, with img/s on the card (grouped by op, and image by image)."""
    import random

    import torch

    from scouter_tpu_torch.data import auto_augment as aa

    card_batch = staged_fixture_batch(dev)
    cpu_batch = card_batch.cpu()
    counts = {}
    for name, (fn, to_arg) in aa._OPS.items():
        args = []
        for i in range(AUG_BATCH):
            level = AUG_LEVELS[i % len(AUG_LEVELS)]
            if name in aa.SIGNED_OPS:
                rng = random.Random(0)
                sign = (i // len(AUG_LEVELS)) % 2
                rng.random = lambda s=sign: float(s)  # 1 negates, 0 keeps
                args.append(to_arg(level, rng))
            else:
                args.append(to_arg(level))
        held_pixels(name, fn(card_batch, args), fn(cpu_batch, args), counts)
    rates = {}
    for label, make in (("AutoAugment v0", lambda: aa.AutoAugment("v0", seed=0)),
                        ("AutoAugment original", lambda: aa.AutoAugment("original", seed=0)),
                        ("RandAugment(2, 9)", lambda: aa.RandAugment(2, 9, seed=0))):
        held_pixels(label, make()(card_batch), make()(cpu_batch), counts)
        for mode in ("grouped", "image by image"):
            times = []
            for _ in range(3):
                policy = make()
                sync(dev)
                t0 = time.perf_counter()
                if mode == "grouped":
                    policy(card_batch)
                else:
                    for img in card_batch:
                        policy(img)
                sync(dev)
                times.append(time.perf_counter() - t0)
            rates[f"{label}, {mode}"] = AUG_BATCH / min(times)
    print(f"augmentation ops and policies, card vs CPU on {AUG_BATCH} fixtures staged to "
          f"{AUG_SIZE} px, pixels off by 1 level (bar {AUG_PIXEL_SHARE:g} of the pixels): "
          f"{json.dumps(counts)}", flush=True)
    print(f"augmentation img/s on the card (batch {AUG_BATCH}, {AUG_SIZE} px, best of 3, host "
          f"clock): {json.dumps({k: round(v, 1) for k, v in rates.items()})} on {card}",
          flush=True)
    return card_batch, rates, counts


def phase_tf_pre(tmp: str, child, dev="cuda"):
    """``TfPreprocessTransform`` on the card from the fixtures' bytes at 224
    px, eval and train (seed 0), against its CPU twin run in ``child``: the
    crop boxes equal, PNG outputs bit for bit, JPEG outputs within
    JPEG_MEAN_LEVEL_BAR on average (nvJPEG's decode)."""
    import os

    import numpy as np

    from scouter_tpu_torch.data import TfPreprocessTransform

    names = FIXTURE_JPEGS + FIXTURE_PNGS
    card = {}
    for train in (False, True):
        t = TfPreprocessTransform(is_training=train, size=224, seed=0, device=dev)
        for name in names:
            out = t((FIXTURES / name).read_bytes())
            if out.device.type != dev or tuple(out.shape) != (224, 224, 3):
                fail(f"TfPreprocessTransform gave {tuple(out.shape)} on {out.device}")
            card[f"{int(train)}/{name}"] = (out.cpu().numpy(), t.last_box)
    if child.wait(timeout=120) != 0:
        fail(f"the CPU TfPreprocessTransform child exited {child.returncode}: "
             f"{child.stderr.read()}")
    cpu = np.load(os.path.join(tmp, "tf_pre_cpu.npz"))
    worst = {}
    for key, (out, box) in card.items():
        if tuple(cpu[key + "/box"]) != tuple(box):
            fail(f"TfPreprocessTransform {key}: crop box {box} on the card, "
                 f"{tuple(cpu[key + '/box'])} on the CPU")
        diff = np.abs(out.astype(np.int16) - cpu[key].astype(np.int16))
        if key.endswith(".png") and diff.any():
            fail(f"TfPreprocessTransform {key}: the card differs from the CPU on PNG bytes")
        if diff.mean() > JPEG_MEAN_LEVEL_BAR:
            fail(f"TfPreprocessTransform {key}: {diff.mean():.4f} levels from the CPU on average")
        worst[key] = round(float(diff.mean()), 4)
    print(f"TfPreprocessTransform at 224 px, eval and train (seed 0), card vs CPU: boxes equal, "
          f"PNG bit for bit, mean level difference per output {json.dumps(worst)} (JPEG bar "
          f"{JPEG_MEAN_LEVEL_BAR})", flush=True)


def phase_batch_augment_and_losses(cfg, model, flagship, staged, dev="cuda"):
    """Mixup (alpha 0.2, smoothing 0.1) and random erasing (p 0.5) on the
    staged batch with draws from a seeded CPU generator, card vs CPU
    (mixup within 1e-6, erasing bit for bit); the three extra losses on the
    flagship's logits card vs CPU within 1e-6 relative; top-1 and top-5
    equal."""
    import torch

    from scouter_tpu_torch.data.extra_augment import mixup, random_erasing
    from scouter_tpu_torch.ops.extra_losses import (jsd_cross_entropy,
                                                    label_smoothing_cross_entropy,
                                                    soft_target_cross_entropy)
    from scouter_tpu_torch.utils import evaluate_top1, evaluate_top5

    x = staged.to(torch.float32)
    labels = torch.arange(x.shape[0], device=dev) % cfg.num_classes
    out = {}
    for where in (dev, "cpu"):
        gen = torch.Generator().manual_seed(19)
        mixed, targets = mixup(x.to(where), labels.to(where), cfg.num_classes, gen, alpha=0.2,
                               smoothing=0.1)
        erased = random_erasing(x.to(where), torch.Generator().manual_seed(19), probability=0.5)
        out[where] = (mixed.cpu(), targets.cpu(), erased.cpu())
    out["card"] = out[dev]
    mix_err = max((a - b).abs().max().item() for a, b in zip(out["card"][:2], out["cpu"][:2]))
    erased_n = int((out["cpu"][2] != x.cpu()).flatten(1).any(1).sum())
    print(f"mixup card vs CPU max|d| {mix_err:.3e} (bar 1e-6); random erasing bit for bit: "
          f"{torch.equal(out['card'][2], out['cpu'][2])} ({erased_n} of {x.shape[0]} images "
          "erased)", flush=True)
    if mix_err > 1e-6 or not torch.equal(out["card"][2], out["cpu"][2]):
        fail("mixup or random erasing differ between the card and the CPU")

    images, y = flagship["image"], flagship["label"]
    gen = torch.Generator().manual_seed(20)
    mixed, soft = mixup(images, y, cfg.num_classes, gen, alpha=0.2, smoothing=0.1)
    erased = random_erasing(images, gen, probability=0.5)
    model.eval()
    with torch.no_grad():
        logits = [model(b)["logits"] for b in (images, mixed, erased)]
    losses = {
        "label_smoothing": lambda l, y, s: label_smoothing_cross_entropy(l[0], y, 0.1),
        "soft_target": lambda l, y, s: soft_target_cross_entropy(l[1], s),
        "jsd": lambda l, y, s: jsd_cross_entropy(*l, y),
    }
    errs = {}
    for name, fn in losses.items():
        got = fn(logits, y, soft).item()
        want = fn([l.cpu() for l in logits], y.cpu(), soft.cpu()).item()
        errs[name] = abs(got - want) / max(abs(want), 1e-30)
        if errs[name] > 1e-6:
            fail(f"{name} on the card {got} is {errs[name]:.3e} from the CPU's {want}")
    tops = {name: (fn(logits[0], y).item(), fn(logits[0].cpu(), y.cpu()).item())
            for name, fn in (("top1", evaluate_top1), ("top5", evaluate_top5))}
    print(f"extra losses on the flagship's logits, card vs CPU relative: {json.dumps(errs)}; "
          f"top-1/top-5 card vs CPU {json.dumps(tops)}", flush=True)
    if any(a != b for a, b in tops.values()):
        fail(f"evaluate_top1/top5 differ between the card and the CPU: {tops}")


def phase_mnist_variants(tmp: str):
    """``load_mnist_variant`` on a FashionMNIST-layout tree and on
    QMNIST-prefixed files: the arrays equal what was written."""
    import gzip
    import os
    import struct

    import numpy as np

    from scouter_tpu_torch.data.mnist import load_mnist_variant

    rng = np.random.RandomState(19)
    for variant, sub, prefix in (("FashionMNIST", "FashionMNIST/raw", ""),
                                 ("QMNIST", "QMNIST", "qmnist-")):
        for train, stem in ((True, "train"), (False, "t10k")):
            images = rng.randint(0, 256, (5, 28, 28)).astype(np.uint8)
            labels = rng.randint(0, 10, 5).astype(np.uint8)
            d = os.path.join(tmp, "mnist", sub)
            os.makedirs(d, exist_ok=True)
            for kind, arr in (("images-idx3", images), ("labels-idx1", labels)):
                head = struct.pack(">I", 0x0800 | arr.ndim) + struct.pack(f">{arr.ndim}I",
                                                                          *arr.shape)
                with gzip.open(os.path.join(d, f"{prefix}{stem}-{kind}-ubyte.gz"), "wb") as f:
                    f.write(head + arr.tobytes())
            x, y = load_mnist_variant(os.path.join(tmp, "mnist"), variant, train)
            if not (np.array_equal(x[..., 0], images) and np.array_equal(y, labels)):
                fail(f"load_mnist_variant({variant!r}, train={train}) read other arrays")
    print("load_mnist_variant: FashionMNIST and QMNIST-prefixed IDX files read back equal",
          flush=True)


def phase_factories(card: str, dev="cuda"):
    """Phase 19 (see the docstring). Returns K1's counts over the phase."""
    import os
    import tempfile

    from scouter_tpu_torch.core import ScouterConfig

    t0 = time.monotonic()
    cfg = ScouterConfig(**FLAGSHIP)
    with tempfile.TemporaryDirectory() as tmp:
        names = FIXTURE_JPEGS + FIXTURE_PNGS
        child = subprocess.Popen(
            [sys.executable, "-c", TF_PRE_CPU, str(ROOT), ",".join(names), str(FIXTURES),
             os.path.join(tmp, "tf_pre_cpu.npz")], stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE, text=True)
        marks = [("start", time.monotonic())]
        try:
            k1_counts(reset=True)
            batch = flagship_batch(cfg, dev)
            step_ms = phase_factory_optimizers(cfg, batch, card, dev)
            marks.append(("optimizers", time.monotonic()))
            model, recipe = phase_recipe(cfg, batch, tmp, card, dev)
            marks.append(("recipe", time.monotonic()))
            staged, rates, counts = phase_augment(card, dev)
            marks.append(("augment", time.monotonic()))
            phase_tf_pre(tmp, child, dev)
            marks.append(("tf_pre", time.monotonic()))
            phase_batch_augment_and_losses(cfg, model, batch, staged, dev)
            phase_mnist_variants(tmp)
            marks.append(("mixup_losses_mnist", time.monotonic()))
            k1 = k1_counts()
        finally:
            if child.poll() is None:
                child.kill()
                child.wait()
    steps = len(FACTORY_NAMES) + RECIPE_STEPS
    # every forward counts in "launches", the train steps' also in "hist_launches"
    want = dict(hist_launches=steps, bwd_launches=steps, launches=steps + RECIPE_STEPS + 3)
    print(f"phase 19 K1 counts: {json.dumps(k1)} (train steps {steps}, eval forwards "
          f"{RECIPE_STEPS + 3})", flush=True)
    if any(k1[k] != v for k, v in want.items()) or k1["bwd_tiled_launches"]:
        fail(f"phase 19 gave K1 counts {k1}, expected {want} and no tiled backward")
    if "PIL" in sys.modules:
        fail("Pillow was imported in phase 19")
    seconds = time.monotonic() - t0
    print(json.dumps({"factories_and_augment": dict(
        optimizer_step_ms=step_ms, recipe=recipe, augment_img_per_s=rates,
        augment_pixels_off=counts, card=card, seconds=seconds,
        seconds_by_part={name: round(t - marks[i][1], 2)
                         for i, (name, t) in enumerate(marks[1:])})}), flush=True)
    print(f"phase 19 (factories, losses, augmentation, TF preprocessing, utils) took "
          f"{seconds:.1f} s", flush=True)
    return k1


# phase 20: training and serving over torch.distributed on the one card
DIST_RUNS = (("mesh_sync_bn", ["--mesh_shape", "1", "--sync_bn", "true"]),
             ("mesh_per_replica_bn", ["--mesh_shape", "1", "--sync_bn", "false"]),
             ("mesh_zero1", ["--mesh_shape", "1,1", "--zero1", "true"]))
DIST_LOSS_BAR = 1e-5  # world 1 over NCCL against no mesh: the same arithmetic
DIST_STEP_LOSS_BAR = 1e-3  # two gloo ranks against one rank's step on the 70 images
DIST_RANKS = 2
DIST_TIMEOUT_S = 300


def recorded_epochs():
    """A context in which every ``Trainer.run_epoch`` appends (mode, epoch,
    its unrounded averages, the process group's backend or None) to the list
    it yields."""
    import contextlib

    import torch.distributed as dist

    from scouter_tpu_torch.train import loop

    @contextlib.contextmanager
    def recording():
        run_epoch, seen = loop.Trainer.run_epoch, []

        def recorded(self, epoch, mode):
            avg = run_epoch(self, epoch, mode)
            seen.append((mode, epoch, dict(avg),
                         dist.get_backend() if dist.is_initialized() else None))
            return avg

        loop.Trainer.run_epoch = recorded
        try:
            yield seen
        finally:
            loop.Trainer.run_epoch = run_epoch

    return recording()


def train_rate(step, state, batch, global_batch: int, steps: int = 10,
               warmup: int = 3) -> float:
    """img/s of ``step`` on one repeated batch (this rank's rows of a global
    batch of ``global_batch``)."""
    import torch

    for _ in range(warmup):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    return global_batch * steps / (time.perf_counter() - t0)


def flagship_state(cfg):
    from scouter_tpu_torch.models import build_slot_model
    from scouter_tpu_torch.train import create_train_state

    return create_train_state(build_slot_model(cfg, fused_slot=True, device="cuda"), cfg.lr)


def dist_cli_child(tmp: str) -> int:
    """``chip_smoke.py dist-cli <tmp>`` under ``torch.distributed.run`` (one
    process): the train CLI once for each of ``DIST_RUNS`` (each starts and
    destroys its group of one), with K1's counts, the unrounded epoch
    averages and the group's backend of each; then, once ``<tmp>/go``
    exists, the flagship's train img/s with a (1,) mesh under the group
    started again, and without a mesh. Prints one JSON line."""
    import os

    import torch

    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from scouter_tpu_torch.core import ScouterConfig
    from scouter_tpu_torch.core.distributed import init_distributed_mode
    from scouter_tpu_torch.parallel import make_mesh
    from scouter_tpu_torch.train import cli, make_train_step

    runs = {}
    torch.backends.cudnn.deterministic = True  # as the run without a mesh it is held to
    for name, extra in DIST_RUNS:
        out = os.path.join(tmp, name)
        k1_counts(reset=True)
        t0 = time.monotonic()
        with recorded_epochs() as epochs:
            cli.main(flagship_flags(out) + ["--epochs", "1", "--lr_drop", "1"] + extra)
        runs[name] = dict(k1=k1_counts(), epochs=epochs, seconds=time.monotonic() - t0,
                          files=sorted(os.listdir(out)))
    torch.backends.cudnn.deterministic = False
    deadline = time.monotonic() + 120
    while not os.path.exists(os.path.join(tmp, "go")) and time.monotonic() < deadline:
        time.sleep(0.2)
    cfg = ScouterConfig(**FLAGSHIP)
    batch = flagship_batch(cfg)
    init_distributed_mode()
    backend = torch.distributed.get_backend()
    mesh = make_mesh((1,))
    rates = {"mesh_1": train_rate(make_train_step(cfg.lambda_value, mesh=mesh),
                                  flagship_state(cfg), batch, cfg.batch_size)}
    torch.distributed.destroy_process_group()
    rates["no_mesh"] = train_rate(make_train_step(cfg.lambda_value), flagship_state(cfg), batch,
                                  cfg.batch_size)
    print(json.dumps({"dist_cli": dict(runs=runs, rates=rates, backend=backend)}), flush=True)
    return 0


def dist_rank_child(rank: int, port: str, tmp: str) -> int:
    """``chip_smoke.py dist-rank <rank> <port> <tmp>``: one of two gloo ranks
    on the one card (``device="cuda:0"`` for both; NCCL refuses two ranks on
    one device). For each BN mode, one flagship train step over a (2,) mesh
    on this rank's 35 of the 70 images, from the seeded weights: the loss,
    K1's counts over the step, the averaged gradients (rank 0 saves them)
    and a checksum of the parameters after it; a checkpoint through
    ``save_checkpoint`` (rank 0 alone writes); the global train img/s with
    global BatchNorm. Writes ``<tmp>/rank<r>.json``."""
    import os

    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(DIST_RANKS), LOCAL_RANK="0",
                      MASTER_ADDR="localhost", MASTER_PORT=port)
    from scouter_tpu_torch.core import ScouterConfig
    from scouter_tpu_torch.core.checkpoint import save_checkpoint
    from scouter_tpu_torch.core.distributed import init_distributed_mode
    from scouter_tpu_torch.parallel import make_mesh, shard_batch
    from scouter_tpu_torch.train import make_train_step

    init_distributed_mode(backend="gloo", device="cuda:0", timeout=DIST_TIMEOUT_S)
    import torch.distributed as dist

    cfg = ScouterConfig(**FLAGSHIP)
    mesh = make_mesh((DIST_RANKS,))
    rows = shard_batch(mesh, flagship_batch(cfg))
    out = dict(rank=rank, backend=dist.get_backend(), steps={})
    for sync_bn in (True, False):
        state = flagship_state(cfg)
        step = make_train_step(cfg.lambda_value, mesh=mesh, sync_bn=sync_bn)
        k1_counts(reset=True)
        state, m = step(state, rows)
        torch.cuda.synchronize()
        k1 = k1_counts()
        params = {n: p.detach().double().cpu() for n, p in state.model.named_parameters()}
        out["steps"][str(sync_bn)] = dict(
            loss=float(m["loss"]), metrics={k: float(v) for k, v in m.items()}, k1=k1,
            checksum=float(sum(np.abs(v.numpy()).sum() for v in params.values())))
        if rank == 0:
            torch.save({n: p.grad.detach().cpu() for n, p in state.model.named_parameters()
                        if p.grad is not None}, os.path.join(tmp, f"grads_{sync_bn}.pt"))
        if sync_bn:
            out["paths"] = [os.path.basename(path) for path in
                            save_checkpoint(os.path.join(tmp, "ckpt"), cfg, state, 0)]
            timed = (step, state)
    deadline = time.monotonic() + DIST_TIMEOUT_S  # the reference's steps end first
    while not os.path.exists(os.path.join(tmp, "go")) and time.monotonic() < deadline:
        time.sleep(0.2)
    out["img_per_s"] = train_rate(*timed, rows, cfg.batch_size, steps=5)
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def dist_reference_grads(cfg, batch, sync_bn: bool, dtype=None):
    """One rank's step on the 70 images without a mesh: the loss and the
    gradients the step leaves; with per-replica BN, the mean of each half's
    own step (its own statistics), as two replicas take it. In float64
    (``dtype``) the slot head runs its plain version (K1 is f32 and bf16)."""
    import torch

    from scouter_tpu_torch.models import build_slot_model
    from scouter_tpu_torch.train import create_train_state, make_train_step

    dtype = dtype or torch.float32
    halves = [batch] if sync_bn else [
        {k: v[i * 35:(i + 1) * 35] for k, v in batch.items()} for i in range(DIST_RANKS)]
    loss, grads = 0.0, {}
    for half in halves:
        model = build_slot_model(cfg, fused_slot=dtype == torch.float32, device="cuda")
        state = create_train_state(model.to(dtype), cfg.lr)
        state, m = make_train_step(cfg.lambda_value)(
            state, {**half, "image": half["image"].to(dtype)})
        loss += float(m["loss"]) / len(halves)
        for n, p in state.model.named_parameters():
            if p.grad is not None:
                grads[n] = grads.get(n, 0) + p.grad.detach().double().cpu() / len(halves)
    torch.cuda.synchronize()
    return loss, grads


def held_grads(what: str, got, ref32, ref64):
    """Each gradient of ``got`` within STEP_GRAD_NORM_BAR of ``ref32``'s in
    norm; one that is zero in exact arithmetic (a conv bias before a train-
    mode BatchNorm: the split-attention's fc1) is f32 noise on both sides,
    and is held instead no further from the float64 step than twice the f32
    reference lies from it (Queue C). Returns the worst relative norm and
    the names held by float64 with the largest ratio of the two distances."""
    if set(got) != set(ref32):
        fail(f"{what}: gradients for {sorted(set(got) ^ set(ref32))} on one side only")
    worst, by_f64, ratio = (0.0, ""), [], 0.0
    for n, g in ref32.items():
        rel = float((got[n].double() - g).norm() / g.norm().clamp_min(1e-30))
        if rel <= STEP_GRAD_NORM_BAR:
            worst = max(worst, (rel, n))
            continue
        ours = float((got[n].double() - ref64[n]).norm())
        theirs = float((g - ref64[n]).norm())
        if ours > 2 * theirs:
            fail(f"{what}: gradient {n} {rel:.3g} from one rank's step in norm, "
                 f"{ours:.3g} from the float64 step (the f32 step's {theirs:.3g})")
        by_f64.append(n)
        ratio = max(ratio, ours / theirs)
    return worst, by_f64, ratio


def phase_dist_engine(cfg, state_dict):
    """(c): the engine with a mesh of the card against the engine without:
    logits bit for bit at buckets 1, 4 and 16."""
    import numpy as np
    import torch

    from scouter_tpu_torch.parallel import make_mesh
    from scouter_tpu_torch.serve import InferenceEngine

    images = np.random.RandomState(20).randint(0, 256, (16, cfg.img_size, cfg.img_size, 3),
                                               np.uint8)
    plain = InferenceEngine(cfg, state_dict, buckets=BUCKETS)
    meshed = InferenceEngine(cfg, state_dict, buckets=BUCKETS,
                             mesh=make_mesh(devices=[torch.device("cuda", 0)]))
    try:
        for b in BUCKETS:
            want, got = plain.infer_batch(images[:b]), meshed.infer_batch(images[:b])
            if not np.array_equal(got["logits"], want["logits"]):
                fail(f"the meshed engine's logits differ at bucket {b}")
    finally:
        plain.close()
        meshed.close()
    print(f"meshed engine (a mesh of the card): logits bit for bit at buckets {BUCKETS}",
          flush=True)


def phase_distributed(card: str):
    """Phase 20 (see the docstring). Returns K1's launches over its train
    steps: the CLI runs' (a) and each gloo rank's (b)."""
    import math
    import os
    import socket

    import torch

    from scouter_tpu_torch.core import ScouterConfig
    from scouter_tpu_torch.models import build_slot_model
    from scouter_tpu_torch.train import cli

    t0 = time.monotonic()
    cfg = ScouterConfig(**FLAGSHIP)
    train_steps, val_batches = 256 // 70, -(-128 // 70)  # the synthetic stand-in
    with tempfile.TemporaryDirectory() as tmp:
        a_tmp, b_tmp = os.path.join(tmp, "a"), os.path.join(tmp, "b")
        os.makedirs(a_tmp)
        os.makedirs(b_tmp)
        # (a)'s launcher and (b)'s two ranks start together; each times its
        # steps only once this process has made its references and writes
        # the directory's "go" file, and (b) only after (a) has ended
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = str(sock.getsockname()[1])
        # the children write to files: a full pipe would stall them unread
        logs = [open(os.path.join(tmp, f"{name}.log"), "w+")
                for name in ["a_out", "a_err"] + [f"rank{r}" for r in range(DIST_RANKS)]]
        child = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", "1", str(ROOT / "chip_smoke.py"), "dist-cli", a_tmp],
            stdout=logs[0], stderr=logs[1], text=True)
        ranks = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "dist-rank",
                                   str(r), port, b_tmp], stdout=logs[2 + r],
                                  stderr=subprocess.STDOUT, text=True)
                 for r in range(DIST_RANKS)]
        try:
            # meanwhile here: the run without a mesh (phase 7's way, cuDNN
            # deterministic, as the launched runs), (c), and (b)'s references
            torch.backends.cudnn.deterministic = True
            try:
                with recorded_epochs() as ref_epochs:
                    run_cli(cli.main, flagship_flags(os.path.join(tmp, "ref"))
                            + ["--epochs", "1", "--lr_drop", "1"])
            finally:
                torch.backends.cudnn.deterministic = False
            phase_dist_engine(cfg, build_slot_model(cfg, device="cpu").state_dict())
            batch = flagship_batch(cfg)
            refs = {sync_bn: (dist_reference_grads(cfg, batch, sync_bn),
                              dist_reference_grads(cfg, batch, sync_bn, torch.float64))
                    for sync_bn in (True, False)}
            open(os.path.join(a_tmp, "go"), "w").close()
            child.wait(timeout=DIST_TIMEOUT_S)
            open(os.path.join(b_tmp, "go"), "w").close()
            for p in ranks:
                p.wait(timeout=DIST_TIMEOUT_S)
        finally:
            for p in [child] + ranks:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        texts = []
        for f in logs:
            f.seek(0)
            texts.append(f.read())
            f.close()
        out, err, logs = texts[0], texts[1], texts[2:]
        if child.returncode != 0:
            fail(f"torch.distributed.run of the train CLI failed:\n{out[-4000:]}\n{err[-4000:]}")
        found = [json.loads(line)["dist_cli"] for line in out.splitlines()
                 if line.startswith('{"dist_cli"')]
        if len(found) != 1:
            fail(f"the launched CLI printed no result:\n{out[-4000:]}\n{err[-4000:]}")
        a = found[0]
        ref = {(mode, e): avg for mode, e, avg, _ in ref_epochs}
        names = ["ImageNet_use_slot_checkpoint.pth", "ImageNet_use_slot_checkpoint0000.pth"]
        a_launches = a_bwd = 0
        for name, run in a["runs"].items():
            k1 = run["k1"]
            hist, plain = k1["hist_launches"], k1["launches"] - k1["hist_launches"]
            if (hist, plain, k1["bwd_launches"]) != (train_steps, val_batches, train_steps):
                fail(f"{name}: K1 hist / hist-free / backward launches {hist} / {plain} / "
                     f"{k1['bwd_launches']}, expected {train_steps} / {val_batches} / "
                     f"{train_steps}")
            a_launches += k1["launches"]
            a_bwd += k1["bwd_launches"]
            if [f for f in names if f not in run["files"]]:
                fail(f"{name}: checkpoints {run['files']}, expected {names}")
            worst, gaps = 0.0, {}
            for mode, e, avg, backend in run["epochs"]:
                if backend != "nccl":
                    fail(f"{name}: the {mode} epoch ran with backend {backend}, not nccl")
                for k, v in avg.items():
                    if not math.isfinite(v):
                        fail(f"{name}: {mode} {k} = {v}")
                    gaps[f"{mode}_{k}"] = abs(v - ref[(mode, e)][k])
                    if k != "acc":  # the losses; acc moves by a whole image
                        worst = max(worst, gaps[f"{mode}_{k}"])
            if worst > DIST_LOSS_BAR:
                fail(f"{name}: epoch losses {worst:.3g} from the run without a mesh: {gaps}")
            print(f"phase 20 (a) {name} under torch.distributed.run (world 1, nccl): "
                  f"{run['seconds']:.1f} s, K1 {hist} / {plain} / {k1['bwd_launches']}, "
                  f"epoch averages within {worst:.3g} of no mesh "
                  f"({json.dumps(run['epochs'][0][2])})", flush=True)
        print(f"phase 20 (a) flagship train img/s at batch 70: {a['rates']['mesh_1']:.1f} "
              f"with a (1,) mesh over {a['backend']}, {a['rates']['no_mesh']:.1f} without, "
              f"on {card}", flush=True)

        # (b): two gloo ranks on the one card against one rank's step here
        for r, (p, log) in enumerate(zip(ranks, logs)):
            if p.returncode != 0:
                fail(f"gloo rank {r} failed:\n{log[-4000:]}")
        results = [json.load(open(os.path.join(b_tmp, f"rank{r}.json")))
                   for r in range(DIST_RANKS)]
        b_launches = b_bwd = 0
        for sync_bn in (True, False):
            key = str(sync_bn)
            steps = [res["steps"][key] for res in results]
            (ref_loss, ref_grads), (_, f64_grads) = refs[sync_bn]
            got = torch.load(os.path.join(b_tmp, f"grads_{sync_bn}.pt"))
            worst, by_f64, ratio = held_grads(f"(b) sync_bn={sync_bn}", got, ref_grads,
                                              f64_grads)
            loss_gap = abs(steps[0]["loss"] - ref_loss)
            if loss_gap > DIST_STEP_LOSS_BAR or len({s["loss"] for s in steps}) != 1:
                fail(f"(b) sync_bn={sync_bn}: losses {[s['loss'] for s in steps]} against "
                     f"{ref_loss}")
            if len({s["checksum"] for s in steps}) != 1:
                fail(f"(b) sync_bn={sync_bn}: the ranks' parameters differ: "
                     f"{[s['checksum'] for s in steps]}")
            for r, s in enumerate(steps):
                if (s["k1"]["hist_launches"], s["k1"]["bwd_launches"]) != (1, 1):
                    fail(f"(b) rank {r} sync_bn={sync_bn}: K1 counts {s['k1']}")
                b_launches += s["k1"]["launches"]
                b_bwd += s["k1"]["bwd_launches"]
            print(f"phase 20 (b) two gloo ranks on the card, sync_bn={sync_bn}: loss "
                  f"{steps[0]['loss']:.6f} against one rank's {ref_loss:.6f} ({loss_gap:.3g}), "
                  f"largest gradient gap {worst[0]:.3g} in norm ({worst[1]}; zero in exact "
                  f"arithmetic, held to float64: {len(by_f64)}, {by_f64[:3]}, at most "
                  f"{ratio:.3g} times the f32 step's distance from it), parameters "
                  f"equal on both ranks (checksum {steps[0]['checksum']:.6f}), K1 hist / "
                  f"backward 1 / 1 on each rank", flush=True)
        if [res["backend"] for res in results] != ["gloo"] * DIST_RANKS:
            fail(f"(b) backends {[res['backend'] for res in results]}")
        written = sorted(os.listdir(os.path.join(b_tmp, "ckpt")))
        if (not results[0]["paths"] or results[1]["paths"] != []
                or written != sorted(results[0]["paths"])):
            fail(f"(b) checkpoint paths {[r['paths'] for r in results]}, files {written}")
        print(f"phase 20 (b) only rank 0 wrote the checkpoint ({', '.join(written)}); global train "
              f"img/s at 2 x 35: {results[0]['img_per_s']:.1f} on {card}", flush=True)
    seconds = time.monotonic() - t0
    print(json.dumps({"distributed": dict(
        train_img_per_s={"mesh_1_nccl": a["rates"]["mesh_1"], "no_mesh": a["rates"]["no_mesh"],
                         "two_gloo_ranks": results[0]["img_per_s"]},
        card=card, seconds=seconds)}), flush=True)
    print(f"phase 20 (distributed) took {seconds:.1f} s", flush=True)
    return dict(cli_launches=a_launches, cli_bwd_launches=a_bwd, gloo_launches=b_launches,
                gloo_bwd_launches=b_bwd)


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
    tiled_entry = phase_kernel_grad_tiled(entry)
    bf16_entry, tiled_bf16_entry = phase_kernel_grad_bf16()

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
    with tempfile.TemporaryDirectory() as tmp:
        summary = phase_bf16_head_and_export(tmp, card)
    entry["artifact_launches"] = summary.pop("artifact_launches")
    bf16_entry["launches"] = summary["flagship_k1_counts"]["bwd_bf16_launches"]
    tiled_bf16_entry["launches"] = summary["cub_k1_counts"]["bwd_tiled_bf16_launches"]
    print(json.dumps({"bf16_head_and_export": summary}), flush=True)
    phase_folder_decode(card)
    with tempfile.TemporaryDirectory() as tmp:
        tree, out, entry["tree_launches"], tiled_entry["tree_launches"] = phase_folder_train(
            tmp, card)
        phase_folder_preempt(tmp)
        entry["tree_explain_launches"] = phase_folder_explain(tree, out)
        phase_folder_serve(out)
    zoo = phase_zoo(card)
    entry["resnet50_launches"] = zoo["train_launches"]
    entry["resnet50_serve_launches"] = zoo["serve_launches"]
    entry["resnet50_explain_launches"] = zoo["explain_launches"]
    entry["os16_hist_launches"] = zoo["os16_hist_launches"]
    bwd_entry["resnet50_launches"] = zoo["bwd_launches"]
    tiled_entry["os16_launches"] = zoo["os16_tiled_launches"]
    tiled_entry["os16_launches_per_call"] = zoo["os16_launches_per_call"]
    entry["xai_launches"] = render_entry["xai_launches"] = phase_xai(card)
    zoo2 = phase_zoo2(card)
    entry["effnet_b2_launches"] = zoo2["train_launches"]
    entry["effnet_b2_serve_launches"] = zoo2["serve_launches"]
    entry["effnet_b2_explain_launches"] = zoo2["explain_launches"]
    entry["densenet121_serve_launches"] = zoo2["dense_serve_launches"]
    bwd_entry["effnet_b2_launches"] = zoo2["bwd_launches"]
    entry["at_70_81_30"], bwd_entry["at_70_81_30"] = zoo2["k1"]["fwd"], zoo2["k1"]["bwd"]
    zoo3 = phase_zoo3(card)
    entry["xception_launches"] = zoo3["train_launches"]
    entry["xception_serve_launches"] = zoo3["serve_launches"]
    entry["xception_explain_launches"] = zoo3["explain_launches"]
    entry["nasnet_serve_launches"] = zoo3["nasnet_serve_launches"]
    entry["nasnet_step_launches"] = zoo3["nasnet_step_launches"]
    bwd_entry["xception_launches"] = zoo3["bwd_launches"]
    bwd_entry["nasnet_step_launches"] = zoo3["nasnet_step_bwd_launches"]
    entry["at_70_100_30"], bwd_entry["at_70_100_30"] = zoo3["k1"]["fwd"], zoo3["k1"]["bwd"]
    entry["at_4_100_30"], bwd_entry["at_4_100_30"] = (zoo3["step_k1"]["fwd"],
                                                      zoo3["step_k1"]["bwd"])
    entry["at_4_121_30"], bwd_entry["at_4_121_30"] = (zoo3["nasnet_k1"]["fwd"],
                                                      zoo3["nasnet_k1"]["bwd"])
    k1 = phase_factories(card)
    entry["factories_hist_launches"], entry["factories_launches"] = (k1["hist_launches"],
                                                                     k1["launches"])
    bwd_entry["factories_launches"] = k1["bwd_launches"]
    dist = phase_distributed(card)
    entry["dist_cli_launches"], bwd_entry["dist_cli_launches"] = (dist["cli_launches"],
                                                                  dist["cli_bwd_launches"])
    entry["dist_gloo_launches"], bwd_entry["dist_gloo_launches"] = (dist["gloo_launches"],
                                                                    dist["gloo_bwd_launches"])
    if "PIL" in sys.modules:
        fail("Pillow was imported")
    print(f"chip_smoke finished in {time.monotonic() - t0:.1f} s after the build started",
          flush=True)

    print(json.dumps({"kernels": [entry, bwd_entry, tiled_entry, bf16_entry, tiled_bf16_entry,
                                  render_entry]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["dist-cli"]:
        sys.exit(dist_cli_child(sys.argv[2]))
    if sys.argv[1:2] == ["dist-rank"]:
        sys.exit(dist_rank_child(int(sys.argv[2]), sys.argv[3], sys.argv[4]))
    sys.exit(main())
