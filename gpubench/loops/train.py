"""Closed training loop: the program's train step back to back, fed by its
Loader.

Set-up builds one training object: the model on the device with the
benchmark's seeded weights, AdamW over it (``train/state.py``), the train
step (``train/steps.py::make_train_step``) and the Loader
(``data/pipeline.py``) over an in-memory uint8 dataset of
``dataset_batches`` batches drawn from the seed, as the Trainer builds them.
The first three steps go through that step and that feed and are read for
the comparison: each step's loss, the first gradient as AdamW holds it after
step one (its first moment over 1 - beta1), and each leaf's change over the
three. ``warm_steps`` more steps follow, then the window: steps back to
back for ``--seconds``, the Loader's ``next()`` timed on the host.

After the window the program is freed and the reference follows the same
three steps from the same weights and the same rows (the Loader's epoch-0
order, ``np.random.RandomState((seed * 100003) % 2**31)``'s shuffle).
"""

from __future__ import annotations

import gc
import itertools
import time
from typing import Dict, Iterator, List

import numpy as np

from ..compare import train_numbers
from ..harness import Ctx, Outcome, port_config, quiesce, seeded_images, seeded_labels
from ..reference import model as ref
from ..reference.precision import EXACT, Precision
from ..weights import make_weights

__all__ = ["TrainRun", "reference_readings", "run"]

CHECKED_STEPS = 3
_BETA1 = 0.9


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _dataset(ctx: Ctx):
    n = ctx.params["dataset_batches"] * ctx.config["batch_size"]
    return seeded_images(ctx, n, stream=2), seeded_labels(ctx, n, stream=3)


def _param_names(ctx: Ctx) -> List[str]:
    """The model's parameters (its state dict without BatchNorm's buffers)."""
    return [name for name, _shape, init in ref.param_spec(ctx.config)
            if init[0] != "count" and not name.endswith(("running_mean", "running_var"))]


class TrainRun:
    """The program's training object for one seed (module docstring)."""

    def __init__(self, ctx: Ctx):
        from scouter_tpu_torch.core.config import compute_dtype
        from scouter_tpu_torch.data import ArrayDataset, Loader
        from scouter_tpu_torch.models import build_slot_model
        from scouter_tpu_torch.train.state import create_train_state
        from scouter_tpu_torch.train.steps import make_train_step

        self.ctx = ctx
        self.batch = ctx.config["batch_size"]
        cfg = port_config(ctx, self.batch)
        model = build_slot_model(cfg, fused_slot=True, device="meta",
                                 compute_dtype=compute_dtype(cfg))
        model = model.to_empty(device=ctx.device)
        model.load_state_dict(make_weights(ref.param_spec(ctx.config), ctx.seed, ctx.device))
        self.state = create_train_state(model, cfg.lr, freeze_layers=cfg.freeze_layers,
                                        pre_trained=cfg.pre_trained)
        self.train_step = make_train_step(float(cfg.lambda_value))
        images, labels = _dataset(ctx)
        self.loader = Loader(ArrayDataset(images, labels, cfg.dataset), self.batch,
                             img_size=cfg.img_size, train=True, aug=bool(ctx.params["aug"]),
                             seed=cfg.seed, device=ctx.device)
        self._batches = self._feed()
        self.loader_s: List[float] = []

    def _feed(self) -> Iterator:
        for epoch in itertools.count():
            yield from self.loader.epoch(epoch)

    def step(self):
        t0 = time.perf_counter()
        batch = next(self._batches)
        self.loader_s.append(time.perf_counter() - t0)
        self.state, metrics = self.train_step(self.state, batch)
        return metrics

    def first_steps(self) -> Dict:
        """The three checked steps and their readings."""
        import torch

        named = dict(self.state.model.named_parameters())
        start = {n: p.detach().clone() for n, p in named.items()}
        opt = self.state.optimizer
        losses, grad = [], {}
        for i in range(CHECKED_STEPS):
            losses.append(float(self.step()["loss"]))
            if i == 0:
                # a leaf AdamW holds no moment for got no gradient: it reads 0
                norms = torch.stack([
                    (opt.state[p]["exp_avg"] / (1.0 - _BETA1)).norm()
                    if "exp_avg" in opt.state.get(p, {}) else p.new_zeros(())
                    for p in named.values()])
                grad = dict(zip(named, norms.tolist()))
        change = torch.stack([(p.detach() - start[n]).norm() for n, p in named.items()])
        return {"losses": losses, "grad": grad, "change": dict(zip(named, change.tolist()))}

    def window(self, seconds: float):
        """Steps back to back for ``seconds``; (steps, wall seconds, host
        seconds in the Loader's next())."""
        _sync(self.ctx.device)
        first = len(self.loader_s)
        t0 = time.perf_counter()
        n = 0
        while True:
            self.step()
            n += 1
            if time.perf_counter() - t0 >= seconds:
                break
        _sync(self.ctx.device)
        return n, time.perf_counter() - t0, t0, self.loader_s[first:]

    def close(self) -> None:
        self._batches.close()
        self.state = self.loader = self._batches = None
        gc.collect()


def reference_readings(ctx: Ctx, precision: Precision = EXACT, half_batch: bool = False) -> Dict:
    """The reference's readings of the checked steps, from the same weights
    and rows. ``half_batch``: the fault of a step that leaves half the batch
    out and takes the mean over the rest (for setting limits)."""
    import torch

    cfg, b = ctx.config, ctx.config["batch_size"]
    images, labels = _dataset(ctx)
    order = np.arange(len(images))
    np.random.RandomState((ctx.seed * 100003) % (2**31)).shuffle(order)
    W = make_weights(ref.param_spec(cfg), ctx.seed, ctx.device)
    names = _param_names(ctx)
    leaves = [W[n].detach().clone().requires_grad_() for n in names]
    W.update(zip(names, leaves))
    start = [t.detach().clone() for t in leaves]
    adam: Dict = {}
    losses, grad = [], {}
    for step in range(1, CHECKED_STEPS + 1):
        rows = order[(step - 1) * b:step * b]
        x = torch.from_numpy(images[rows]).to(ctx.device)
        y = torch.from_numpy(labels[rows]).to(ctx.device)
        logits, area, _ = ref.forward(W, x, cfg, train=True, precision=precision)
        if half_batch:
            h = b // 2
            logits, y = logits[:h], y[:h]
        loss = ref.loss_of(logits, area, y, cfg)
        grads = torch.autograd.grad(loss, leaves)
        losses.append(float(loss.detach()))
        if step == 1:
            grad = dict(zip(names, torch.stack([g.norm() for g in grads]).tolist()))
        ref.adamw_step(leaves, grads, adam, step, float(cfg["lr"]))
        del logits, area, loss, grads
    change = torch.stack([(p.detach() - s).norm() for p, s in zip(leaves, start)])
    return {"losses": losses, "grad": grad, "change": dict(zip(names, change.tolist()))}


def run(ctx: Ctx) -> Outcome:
    import torch

    from ..trace import WINDOW, Tracer

    prog = TrainRun(ctx)
    seconds = min(ctx.seconds, float(ctx.params["trace_seconds"])) if ctx.trace else ctx.seconds
    tracer = Tracer() if ctx.trace else None
    try:
        readings = prog.first_steps()
        for _ in range(int(ctx.params["warm_steps"])):
            prog.step()
        quiesce()
        if tracer is not None:
            with tracer, torch.profiler.record_function(WINDOW):
                steps, wall, t0, loader_s = prog.window(seconds)
        else:
            steps, wall, t0, loader_s = prog.window(seconds)
        peak = (int(torch.cuda.max_memory_allocated(ctx.device)) if ctx.device.type == "cuda"
                else 0)
    finally:
        prog.close()
    del prog
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = train_numbers(readings, reference_readings(ctx))
    images = steps * ctx.config["batch_size"]
    return Outcome(
        e2e={"train_img_s": images / wall, "setup_s": t0 - ctx.t_start},
        attempted=steps, failed=0, numbers=numbers, memory_peak_bytes=peak, window_s=wall,
        trace=tracer.data if tracer is not None else None,
        layer={"steps": steps, "images": images, "loader_s": loader_s, "batch": ctx.config[
            "batch_size"], "train": True})
