"""Train and eval steps (counterpart of ``scouter_tpu/train/steps.py``).

One call is one whole step: forward, loss, backward and optimizer update for
training; forward and metrics under ``torch.no_grad()`` for eval. Metrics
(loss, CE loss, area loss, top-1 fraction) stay on the device as 0-d tensors;
the epoch loop sums them there and fetches once per epoch, where the
reference syncs with ``.item()`` every batch (``engine.py:36``).

Under a bf16 compute dtype the model's logits may be bf16; the loss and the
metrics are reduced in f32 (``ops.losses`` upcasts the logits), as in
``scouter_tpu/train/steps.py``. Mode switches are part of the step: ``build_slot_model`` returns the model in
eval mode, the train step puts it in train mode (batch statistics, running
stats updated) and the eval step back in eval mode, so the slot head's K1
call takes the hist build under grad and the hist-free build in eval.

On a mesh (``make_train_step(mesh=...)``) each rank steps on its rows of the
global batch, and the step's metrics are the global ones on every rank
(``scouter_tpu/train/steps.py:82-143``):

- ``sync_bn=True`` (JAX's default, a plain jit over the global batch):
  BatchNorm's batch statistics, the mean NLL and the area loss are taken
  over the ``data`` group's global batch through collectives with a
  gradient, and the gradients are averaged over the group;
- ``sync_bn=False`` (JAX's shard_map path): each replica normalises with
  its own batch and takes its own loss, the gradients are averaged, the
  loss terms too, ``acc`` is the summed correct count over the summed mask,
  and the running statistics follow data-rank 0 (a broadcast);
- sharded parameters (``parallel/tp.py``) are gathered over the ``model``
  group for the forward, and ZeRO-1's AdamW steps on this rank's slices
  (``state.optimizer_step``).

At world size 1 the group is None and the step is the one-process step.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from ..models import layers
from ..ops.losses import scouter_loss
from ..parallel.mesh import all_reduce_sum
from ..parallel.tp import gather_full, gather_shard, local_slices
from .state import TrainState, optimizer_step

__all__ = ["make_eval_step", "make_train_step", "set_learning_rate"]

Batch = Dict[str, torch.Tensor]
Metrics = Dict[str, torch.Tensor]


def _metrics(out, losses, labels, mask=None) -> Metrics:
    correct = (out["logits"].argmax(dim=1) == labels).to(torch.float32)
    if mask is not None:
        acc = (correct * mask).sum() / mask.sum().clamp_min(1.0)
    else:
        acc = correct.mean()
    loss = losses["loss"].detach()
    return {
        "loss": loss,
        "acc": acc,
        "log_loss": losses.get("log_loss", losses["loss"]).detach(),
        "att_loss": losses.get("att_loss", torch.zeros((), device=loss.device)).detach(),
    }


def _forward(state: TrainState, images: torch.Tensor):
    """The model on ``images``; where the state holds shards split over
    ``model``, with each gathered (parameters through ``gather_shard``,
    buffers without a gradient), and in train mode the updated buffers
    sliced back into this rank's shards."""
    sh = state.shardings
    names = sh.gathered_names() if sh is not None else []
    if not names:
        return state.model(images)
    params = dict(state.model.named_parameters())
    buffers = dict(state.model.named_buffers())
    group = sh.mesh.group("model")
    full = {}
    for name in names:
        if name in params:
            full[name] = gather_shard(params[name], sh.params[name].index("model"), group)
        else:
            full[name] = gather_full(buffers[name], sh.buffers[name], sh.mesh)
    out = torch.func.functional_call(state.model, full, (images,), strict=False)
    if state.model.training:
        with torch.no_grad():
            for name in names:
                if name in buffers:
                    t = full[name]
                    buffers[name].copy_(t[local_slices(t.shape, sh.buffers[name], sh.mesh)])
    return out


def _power(model) -> float:
    return float(model.slot.cfg.power)


def _global_losses(model, out, labels, lambda_value: float, group) -> Dict[str, torch.Tensor]:
    """``scouter_loss`` over the group's global batch: the mean NLL and the
    area loss ``(sum(attn) / (B*S*N)) ** power`` of the global batch, their
    sums crossing ranks with a gradient."""
    log_probs = torch.log_softmax(out["logits"].to(torch.float32), dim=1)
    nll_sum = -log_probs.gather(1, labels.long()[:, None]).sum()
    count = torch.tensor(float(labels.shape[0]), device=nll_sum.device)
    attn = out.get("attn") if out.get("area_loss") is not None else None
    area_sum = attn.sum().to(torch.float32) if attn is not None else torch.zeros_like(count)
    sums = all_reduce_sum(torch.stack([nll_sum, area_sum, count]), group)
    nll = sums[0] / sums[2]
    if attn is None:
        return {"loss": nll}
    area = torch.pow(sums[1] / (sums[2] * float(attn.shape[1] * attn.shape[2])),
                     _power(model))
    return {"loss": nll + lambda_value * area, "log_loss": nll, "att_loss": area}


def _correct_and_mask(out, labels, mask):
    correct = (out["logits"].argmax(dim=1) == labels).to(torch.float32)
    m = mask.to(torch.float32) if mask is not None else torch.ones_like(correct)
    return (correct * m).sum(), m.sum()


def _broadcast_buffers(model, mesh) -> None:
    """The running statistics of data-rank 0 on every rank of the group."""
    bufs = [b for b in model.buffers() if b.is_floating_point()]
    if not bufs:
        return
    flat = _flatten_dense_tensors(bufs)
    dist.broadcast(flat, src=mesh.rank_at(data=0), group=mesh.group("data"))
    for b, v in zip(bufs, _unflatten_dense_tensors(flat, bufs)):
        b.copy_(v)


def make_train_step(lambda_value: float, clip_grad: Optional[float] = None, mesh=None,
                    sync_bn: bool = True, state_shardings=None
                    ) -> Callable[[TrainState, Batch], Tuple[TrainState, Metrics]]:
    """Build ``train_step(state, batch) -> (state, metrics)``.

    ``batch`` holds ``image`` (B, C, H, W) in the model's dtype and ``label``
    (B,) on the model's device, and optionally ``mask`` (B,): on a mesh, this
    rank's rows of the global batch. ``clip_grad`` reproduces the
    reference's (commented-out) clip_gradient helper (engine.py:55-65):
    elementwise clamp of the gradients to [-c, c]. ``mesh``/``sync_bn``: see
    the module docstring. ``state_shardings`` (tensor parallelism / ZeRO-1,
    ``parallel/tp.py``) needs ``sync_bn=True``, as in the JAX package.
    """
    if state_shardings is not None and not sync_bn:
        raise ValueError(
            "state_shardings (TP/ZeRO-1) requires sync_bn=True — the "
            "per-replica shard_map path is data-axis-only")
    group = mesh.group("data") if mesh is not None else None
    dp = mesh.size("data") if mesh is not None else 1

    def train_step(state: TrainState, batch: Batch):
        model = state.model
        model.train()
        model.zero_grad(set_to_none=True)
        state.optimizer.zero_grad(set_to_none=True)
        labels, mask = batch["label"], batch.get("mask")
        if group is not None and sync_bn:
            with layers.batch_norm_group(group):
                out = _forward(state, batch["image"])
            losses = _global_losses(model, out, labels, lambda_value, group)
        else:
            out = _forward(state, batch["image"])
            _, losses = scouter_loss(out["logits"], labels, out.get("area_loss"), lambda_value)
        losses["loss"].backward()
        optimizer_step(state, group, dp, clip_grad)
        state.step += 1
        if group is None:
            return state, _metrics(out, losses, labels, mask)
        metrics = _metrics(out, losses, labels, None)
        with torch.no_grad():
            if not sync_bn:
                _broadcast_buffers(model, mesh)
            stats = torch.stack([metrics["loss"], metrics["log_loss"], metrics["att_loss"],
                                 *_correct_and_mask(out, labels, mask)])
            dist.all_reduce(stats, group=group)
            if not sync_bn:  # the replicas' own losses: their mean
                for i, k in enumerate(("loss", "log_loss", "att_loss")):
                    metrics[k] = stats[i] / float(dp)
            metrics["acc"] = stats[3] / stats[4].clamp_min(1.0)
        return state, metrics

    return train_step


def make_eval_step(lambda_value: float, mesh=None) -> Callable[[TrainState, Batch], Metrics]:
    """Build ``eval_step(state, batch) -> metrics``.

    With a padded batch (``mask`` present) every loss component is taken over
    the real samples only: the reference's tail val batch is simply smaller
    (engine.py:17-52). The area loss is re-derived per sample from the
    attention (mean of relu(attn) over (S, N), masked batch mean, then
    ^power), the batch-global form of slot_attention.py:93-96. On a mesh the
    masked sums are the ``data`` group's, so the metrics are the global
    batch's on every rank."""
    group = mesh.group("data") if mesh is not None else None

    def eval_step(state: TrainState, batch: Batch) -> Metrics:
        model = state.model
        model.eval()
        with torch.no_grad():
            out = _forward(state, batch["image"])
            labels, mask = batch["label"], batch.get("mask")
            if mask is None and group is None:
                _, losses = scouter_loss(out["logits"], labels, out.get("area_loss"),
                                         lambda_value)
                return _metrics(out, losses, labels, None)
            if mask is None:
                mask = torch.ones(labels.shape, device=labels.device)
            mask = mask.to(torch.float32)
            log_probs = torch.log_softmax(out["logits"].to(torch.float32), dim=1)
            per_nll = -log_probs.gather(1, labels.long()[:, None])[:, 0]
            slot = out.get("area_loss") is not None and "attn" in out
            per_area = (torch.relu(out["attn"].to(torch.float32)).mean(dim=(1, 2)) if slot
                        else torch.zeros_like(per_nll))
            if group is None:
                denom = mask.sum().clamp_min(1.0)
                nll = (per_nll * mask).sum() / denom
                area_mean = (per_area * mask).sum() / denom
                metrics_mask = mask
            else:
                correct, _ = _correct_and_mask(out, labels, mask)
                sums = torch.stack([(per_nll * mask).sum(), (per_area * mask).sum(),
                                    mask.sum(), correct])
                dist.all_reduce(sums, group=group)
                denom = sums[2].clamp_min(1.0)
                nll, area_mean = sums[0] / denom, sums[1] / denom
                metrics_mask = None
            if slot:
                area = area_mean ** _power(model)
                losses = {"loss": nll + lambda_value * area, "log_loss": nll, "att_loss": area}
            else:
                losses = {"loss": nll}
            metrics = _metrics(out, losses, labels, metrics_mask)
            if group is not None:
                metrics["acc"] = sums[3] / denom
            return metrics

    return eval_step


def set_learning_rate(state: TrainState, lr: float) -> TrainState:
    """Set the lr of every parameter group (StepLR per epoch, train.py:179)."""
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    return state
