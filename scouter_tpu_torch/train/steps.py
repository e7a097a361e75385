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
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from ..ops.losses import scouter_loss
from .state import TrainState

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


def make_train_step(lambda_value: float, clip_grad: Optional[float] = None
                    ) -> Callable[[TrainState, Batch], Tuple[TrainState, Metrics]]:
    """Build ``train_step(state, batch) -> (state, metrics)``.

    ``batch`` holds ``image`` (B, C, H, W) in the model's dtype and ``label``
    (B,) on the model's device, and optionally ``mask`` (B,). ``clip_grad``
    reproduces the reference's (commented-out) clip_gradient helper
    (engine.py:55-65): elementwise clamp of the gradients to [-c, c].
    """

    def train_step(state: TrainState, batch: Batch):
        model, opt = state.model, state.optimizer
        model.train()
        out = model(batch["image"])
        _, losses = scouter_loss(out["logits"], batch["label"], out.get("area_loss"),
                                 lambda_value)
        opt.zero_grad(set_to_none=True)
        losses["loss"].backward()
        if clip_grad is not None:
            for group in opt.param_groups:
                for p in group["params"]:
                    if p.grad is not None:
                        p.grad.clamp_(-clip_grad, clip_grad)
        opt.step()
        state.step += 1
        return state, _metrics(out, losses, batch["label"], batch.get("mask"))

    return train_step


def make_eval_step(lambda_value: float) -> Callable[[TrainState, Batch], Metrics]:
    """Build ``eval_step(state, batch) -> metrics``.

    With a padded batch (``mask`` present) every loss component is taken over
    the real samples only: the reference's tail val batch is simply smaller
    (engine.py:17-52). The area loss is re-derived per sample from the
    attention (mean of relu(attn) over (S, N), masked batch mean, then
    ^power), the batch-global form of slot_attention.py:93-96."""

    def eval_step(state: TrainState, batch: Batch) -> Metrics:
        model = state.model
        model.eval()
        with torch.no_grad():
            out = model(batch["image"])
            labels, mask = batch["label"], batch.get("mask")
            if mask is None:
                _, losses = scouter_loss(out["logits"], labels, out.get("area_loss"),
                                         lambda_value)
                return _metrics(out, losses, labels, None)
            mask = mask.to(torch.float32)
            denom = mask.sum().clamp_min(1.0)
            log_probs = torch.log_softmax(out["logits"].to(torch.float32), dim=1)
            per_nll = -log_probs.gather(1, labels.long()[:, None])[:, 0]
            nll = (per_nll * mask).sum() / denom
            if out.get("area_loss") is not None and "attn" in out:
                power = float(model.slot.cfg.power)
                per_area = torch.relu(out["attn"].to(torch.float32)).mean(dim=(1, 2))
                area = ((per_area * mask).sum() / denom) ** power
                losses = {"loss": nll + lambda_value * area, "log_loss": nll, "att_loss": area}
            else:
                losses = {"loss": nll}
            return _metrics(out, losses, labels, mask)

    return eval_step


def set_learning_rate(state: TrainState, lr: float) -> TrainState:
    """Set the lr of every parameter group (StepLR per epoch, train.py:179)."""
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    return state
