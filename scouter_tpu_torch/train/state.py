"""Train state: model + AdamW + step counter, with the reference's freeze
rule (counterpart of ``scouter_tpu/train/state.py``).

Optimizer parity (``train.py:146-148``): torch ``AdamW(params, lr=args.lr)``
keeps AdamW's defaults for everything else, betas (0.9, 0.999), eps 1e-8 and
weight_decay 0.01; the reference's ``--weight_decay`` flag is parsed and
never passed to the optimizer. Only trainable parameters are handed to it, so
frozen ones get neither updates nor weight decay (``optax.set_to_zero`` in
the JAX package). StepLR(step_size=lr_drop, gamma 0.1) steps per epoch
(``train.py:179``): :func:`step_lr` gives the epoch's lr and
``steps.set_learning_rate`` writes it.

Freeze rule (``sloter/slot_model.py:79-94`` dfs_freeze): when
``pre_trained`` and ``freeze_layers > 0``, every backbone parameter whose
top-level module name contains none of
``['layer4','layer3','layer2','layer1'][:4 - freeze_layers]`` is frozen.
The slot head (conv1x1, slot) is always trainable. BatchNorm running stats
are buffers, not parameters: frozen layers still update them in train mode,
as in the JAX package and the reference.

On a mesh (``parallel/tp.py::shard_train_state``) the state holds this
rank's shards and :func:`optimizer_step` averages the gradients over the
``data`` group before AdamW steps; under ZeRO-1 each rank reduce-scatters
them to its ``data`` slice, steps AdamW on that slice with its slices of the
moments, and all-gathers the updated slices. AdamW is elementwise, so the
numbers are the unsharded step's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, Optional

import torch
import torch.distributed as dist
from torch import nn
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

__all__ = ["TrainState", "create_train_state", "make_freeze_labels", "make_optimizer",
           "optimizer_step", "restore_inference_state", "step_lr", "sync_batch_stats"]


@dataclasses.dataclass
class TrainState:
    """The model (parameters and BN statistics), its optimizer and the
    number of train steps taken."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    # this rank's layout on a mesh (parallel/tp.py::StateShardings); None
    # where the state is whole
    shardings: Optional[Any] = None


def _kept_layer_names(freeze_layers: int):
    return ["layer4", "layer3", "layer2", "layer1"][: 4 - freeze_layers]


def make_freeze_labels(names: Iterable[str], freeze_layers: int,
                       pre_trained: bool) -> Dict[str, str]:
    """'trainable' / 'frozen' for each parameter name (dfs_freeze parity).

    ``names`` are the model's parameter names (``named_parameters()``); the
    top-level module of a backbone parameter is the part after ``backbone.``
    (``conv1``, ``bn1``, ``layer1``, ...)."""
    names = list(names)
    if not pre_trained or freeze_layers <= 0:
        return {n: "trainable" for n in names}
    kept = _kept_layer_names(freeze_layers)
    labels = {}
    for name in names:
        parts = name.split(".")
        if parts[0] == "backbone":
            module = parts[1] if len(parts) > 2 else ""
            labels[name] = "trainable" if any(k in module for k in kept) else "frozen"
        else:
            labels[name] = "trainable"
    return labels


def step_lr(base_lr: float, epoch: int, lr_drop: int, gamma: float = 0.1) -> float:
    """torch StepLR schedule value at a given epoch."""
    return base_lr * (gamma ** (epoch // lr_drop))


def make_optimizer(params, base_lr: float) -> torch.optim.AdamW:
    """AdamW with torch defaults and the reference's weight decay 0.01."""
    return torch.optim.AdamW(params, lr=base_lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=0.01)


def create_train_state(model: nn.Module, base_lr: float, freeze_layers: int = 0,
                       pre_trained: bool = False) -> TrainState:
    """Mark the frozen parameters ``requires_grad=False`` and build AdamW over
    the rest. A fresh optimizer state each call (``load_variables`` parity).
    AdamW's moments take the parameters' dtype: f32, also under a bf16
    compute dtype (``build_slot_model(..., compute_dtype=...)``)."""
    labels = make_freeze_labels((n for n, _ in model.named_parameters()),
                                freeze_layers, pre_trained)
    trainable = []
    for name, p in model.named_parameters():
        p.requires_grad_(labels[name] == "trainable")
        if p.requires_grad:
            trainable.append(p)
    return TrainState(model=model, optimizer=make_optimizer(trainable, base_lr))


def restore_inference_state(cfg, *, fused_slot: bool = True, require: bool = False,
                            device="cuda"):
    """Build the model and train state on ``device`` and restore the
    config-derived checkpoint (the reference's test.py flow, ``test.py:59-62``).
    Returns ``(model, state, restored_path_or_None)``; without a checkpoint
    the model keeps its fresh init from ``cfg.seed``, or, with ``require``,
    ``FileNotFoundError`` is raised. Shared by the explain CLI and the
    server so the restore recipe cannot diverge between them.

    The optimizer is not restored: inference does not read it, and a
    reference checkpoint's optimizer also holds the bypassed ``to_q``."""
    import os

    from ..core.checkpoint import checkpoint_path, restore_checkpoint
    from ..models import build_slot_model

    model = build_slot_model(cfg, fused_slot=fused_slot, device=device)
    state = create_train_state(model, cfg.lr)
    path = checkpoint_path(cfg.output_dir, cfg)
    if not os.path.exists(path):
        if require:
            raise FileNotFoundError(f"no checkpoint at {path}")
        return model, state, None
    state, _, _ = restore_checkpoint(path, state, optimizer=False)
    return model, state, path


def _all_reduce_mean(tensors, group, n: int) -> None:
    """Average ``tensors`` in place over ``group`` (n ranks), in one flat
    collective."""
    flat = _flatten_dense_tensors(tensors)
    dist.all_reduce(flat, group=group)
    flat.div_(float(n))
    for t, r in zip(tensors, _unflatten_dense_tensors(flat, tensors)):
        t.copy_(r)


_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def optimizer_step(state: TrainState, data_group=None, dp: int = 1,
                   clip_grad: Optional[float] = None) -> None:
    """Average the gradients over ``data_group`` (``dp`` ranks), clamp them to
    [-clip_grad, clip_grad] if asked, and step the optimizer. Under ZeRO-1
    (``state.shardings.leaves``) a parameter with a ``data`` dim is
    reduce-scattered to this rank's slice, stepped there and all-gathered."""
    leaves = state.shardings.leaves if state.shardings is not None else []
    if not leaves:
        params = [p for g in state.optimizer.param_groups for p in g["params"]
                  if p.grad is not None]
        if data_group is not None and params:
            _all_reduce_mean([p.grad for p in params], data_group, dp)
        _clamp([p.grad for p in params], clip_grad)
        state.optimizer.step()
        return
    whole = [p for p, _, z in leaves if z is None and p.grad is not None]
    if data_group is not None and whole:
        _all_reduce_mean([p.grad for p in whole], data_group, dp)
    for p, leaf, z in leaves:
        if z is None:
            continue
        if p.grad is None:
            leaf.grad = None
            continue
        g = p.grad.movedim(z, 0).contiguous()
        out = torch.empty((g.shape[0] // dp,) + g.shape[1:], dtype=g.dtype, device=g.device)
        _reduce_scatter(out, g, group=data_group)
        leaf.grad = out.div_(float(dp)).movedim(0, z).contiguous()
    _clamp([leaf.grad for _, leaf, _ in leaves if leaf.grad is not None], clip_grad)
    state.optimizer.step()
    with torch.no_grad():
        for p, leaf, z in leaves:
            if z is not None:
                parts = [torch.empty_like(leaf) for _ in range(dp)]
                dist.all_gather(parts, leaf.contiguous(), group=data_group)
                p.copy_(torch.cat(parts, z))


def _clamp(grads, clip_grad: Optional[float]) -> None:
    if clip_grad is not None:
        for g in grads:
            g.clamp_(-clip_grad, clip_grad)


def sync_batch_stats(state: TrainState, mesh=None) -> TrainState:
    """Average the BatchNorm statistics (the model's floating buffers) over
    the replicas (timm's ``distribute_bn`` with reduce, the JAX package's
    ``train/state.py:133-154``): over the mesh's ``data`` group, the ranks
    that hold the same shards, or over the world without a mesh. A world of
    one process is left as it is."""
    from ..core.distributed import get_world_size

    if mesh is not None:
        group, n = mesh.group("data"), mesh.size("data")
    else:
        group, n = (dist.group.WORLD if get_world_size() > 1 else None), get_world_size()
    bufs = [b for b in state.model.buffers() if b.is_floating_point()]
    if group is not None and bufs:
        with torch.no_grad():
            _all_reduce_mean(bufs, group, n)
    return state
