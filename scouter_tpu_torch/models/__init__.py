"""Backbones and the SCOUTER SlotModel in PyTorch (NCHW)."""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from . import zoo  # noqa: F401  (registers the entrypoints)
from ..core.device import resolve_device
from .convert import variables_to_state_dict
from .registry import create_model, is_model, list_models, model_entrypoint, register_model
from .resnet import ResNet
from .slot_model import SlotModel, XSlot

__all__ = [
    "ResNet",
    "SlotModel",
    "XSlot",
    "build_slot_model",
    "create_model",
    "init_weights",
    "is_model",
    "list_models",
    "model_entrypoint",
    "register_model",
    "variables_to_state_dict",
]

# the standard deviation of N(0, 1) truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def _trunc_normal_(t: torch.Tensor, std: float, g: torch.Generator) -> None:
    """N(0, std) truncated to two standard deviations, by inverse CDF."""
    lo, hi = (0.5 * (1.0 + math.erf(x / math.sqrt(2.0))) for x in (-2.0, 2.0))
    with torch.no_grad():
        t.uniform_(2 * lo - 1, 2 * hi - 1, generator=g).erfinv_()
        t.mul_(std * math.sqrt(2.0)).clamp_(-2 * std, 2 * std)


def _variance_scaling_(w: torch.Tensor, scale: float, fan: int, g: torch.Generator) -> None:
    _trunc_normal_(w, math.sqrt(scale / fan) / _TRUNC_STD, g)


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Initialise ``model`` in place from ``generator`` with the JAX package's
    distributions: fan-out truncated normal (scale 2) for the backbone convs
    built by ``layers.conv2d``, LeCun truncated normal for the other convs and
    the classifier, unit/zero BatchNorm, torch-default uniform for the xSlot
    Linear and GRU weights, and initial slots drawn as N(mu, |sigma|) with
    standard-normal mu and sigma per feature."""
    g = generator
    in_slot = {sub for m in model.modules() if isinstance(m, XSlot) for sub in m.modules()}
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                o, i_g, kh, kw = m.weight.shape
                if getattr(m, "fan_out_init", False):
                    _variance_scaling_(m.weight, 2.0, o * kh * kw, g)
                else:
                    _variance_scaling_(m.weight, 1.0, i_g * kh * kw, g)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
            elif isinstance(m, XSlot):
                d = m.cfg.dim
                bound = 1.0 / math.sqrt(d)
                mu = torch.empty(1, 1, d).normal_(generator=g)
                sigma = torch.empty(1, 1, d).normal_(generator=g)
                draw = torch.empty_like(m.initial_slots).normal_(generator=g)
                m.initial_slots.copy_(mu + sigma.abs() * draw)
                for p in list(m.to_k.parameters()) + list(m.gru.parameters()):
                    p.uniform_(-bound, bound, generator=g)
            elif isinstance(m, nn.Linear) and m not in in_slot:
                _variance_scaling_(m.weight, 1.0, m.in_features, g)
                m.bias.zero_()


def build_slot_model(cfg, fused_slot: bool = False, dtype: Optional[torch.dtype] = None,
                     device="cuda", generator: Optional[torch.Generator] = None,
                     compute_dtype: Optional[torch.dtype] = None) -> SlotModel:
    """Build the SlotModel of a ScouterConfig in eval mode on ``device``.

    - MNIST swaps the stem conv for Conv(1->64, 3x3, s2, p1)
    - slot mode reads the backbone's features (no classifier is built)
    - no-slot mode keeps the backbone's ``num_classes`` classifier
    - ``dtype`` (e.g. bf16, serving) casts the backbone's parameters to it;
      the slot head stays f32 unless ``cfg.slot_head_dtype == 'compute'``
    - ``compute_dtype`` (e.g. bf16, training) keeps every parameter f32 and
      runs the backbone's convs, BatchNorms and classifier in it, as the JAX
      package's ``build_slot_model(cfg, dtype=...)`` (flax's ``dtype`` over
      f32 ``param_dtype``); the slot head computes in f32 (the refusal of
      ``slot_head_dtype='compute'`` in training is ``check_training_supported``'s)
    - ``fused_slot`` runs the xSlot loop through the CUDA kernel
      (``ops.slot_kernel``); ``generator`` seeds the init (default: cfg.seed)
    """
    dev = resolve_device(device)
    mnist = cfg.dataset == "MNIST"
    backbone = create_model(cfg.model, num_classes=0 if cfg.use_slot else cfg.num_classes,
                            in_chans=1 if mnist else 3, mnist_stem=mnist,
                            compute_dtype=compute_dtype)
    model = SlotModel(
        backbone=backbone,
        use_slot=cfg.use_slot,
        num_classes=cfg.num_classes,
        hidden_dim=cfg.hidden_dim,
        slots_per_class=cfg.slots_per_class,
        loss_status=float(cfg.loss_status),
        power=float(cfg.power),
        to_k_layer=cfg.to_k_layer,
        lambda_value=float(cfg.lambda_value),
        fused_slot=fused_slot,
    )
    init_weights(model, generator or torch.Generator().manual_seed(cfg.seed))
    if dtype is not None:
        if cfg.slot_head_dtype == "compute" or not cfg.use_slot:
            model.to(dtype)
        else:
            model.backbone.to(dtype)
    return model.eval().to(dev)
