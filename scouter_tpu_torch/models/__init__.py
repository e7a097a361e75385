"""Backbones and the SCOUTER SlotModel in PyTorch (NCHW)."""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

# importing the family modules registers their entrypoints
from . import densenet, dla, dpn, efficientnet, gluon_xception, hrnet  # noqa: F401
from . import inception_resnet_v2, inception_v3, inception_v4, nasnet, pnasnet  # noqa: F401
from . import regnet, selecsls, senet, tresnet, vovnet, xception, zoo  # noqa: F401
from ..core.device import resolve_device
from ..ops.slot_attention import init_xslot_params
from .convert import (
    merge_variables,
    prepare_pretrained_state_dict,
    strip_prefix,
    variables_to_state_dict,
)
from .registry import create_model, is_model, list_models, model_entrypoint, register_model
from .resnet import ResNet
from .slot_model import SlotModel, SlotModelOutput, XSlot
from .efficientnet import CondConv2d
from .vovnet import EvoNormSample2d

__all__ = [
    "ResNet",
    "SlotModel",
    "SlotModelOutput",
    "XSlot",
    "auto_fused_slot",
    "build_slot_model",
    "create_model",
    "init_weights",
    "is_model",
    "list_models",
    "merge_variables",
    "model_entrypoint",
    "prepare_pretrained_state_dict",
    "register_model",
    "strip_prefix",
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


def auto_fused_slot(cfg, train: bool, batch_size=None) -> bool:
    """The JAX package's slot-kernel selection hook, which returns False for
    every config there: its Pallas kernel stays opt-in. The port's entry
    points always build ``fused_slot=True`` (K1 is the CUDA kernel on the
    card and its plain version on the CPU), so the hook answers as JAX's
    does and nothing here reads it."""
    del cfg, train, batch_size
    return False


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Initialise ``model`` in place from ``generator`` with the JAX package's
    distributions: fan-out truncated normal (scale 2) for the backbone convs
    built by ``layers.conv2d`` (depthwise and grouped ones too, their fan
    the kernel's output count times its taps) and the space-to-depth stem
    conv, LeCun truncated normal with zero bias for the other convs (the
    gates' flax ``nn.Conv``s, ECA's Conv1d, the 1x1 heads, the slot head's
    1x1) and the Linears (classifiers, CondConv routing), unit/zero
    BatchNorm, each CondConv expert kaiming-uniform over its own fan
    (``scouter_tpu/models/efficientnet.py:285-292``), EvoNorm's weight,
    bias and v at ones, zeros and ones, torch-default uniform for the xSlot
    Linear and GRU weights, and initial slots drawn as N(mu, |sigma|) with
    standard-normal mu and sigma per feature."""
    g = generator
    in_slot = {sub for m in model.modules() if isinstance(m, XSlot) for sub in m.modules()}
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv1d, nn.Conv2d)):
                o, i_g, *taps = m.weight.shape
                if getattr(m, "fan_out_init", False):
                    _variance_scaling_(m.weight, 2.0, o * math.prod(taps), g)
                else:
                    _variance_scaling_(m.weight, 1.0, i_g * math.prod(taps), g)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
            elif isinstance(m, CondConv2d):
                bound = 1.0 / math.sqrt(m.in_chs // m.groups * m.kernel_size ** 2)
                m.weight.uniform_(-bound, bound, generator=g)
            elif isinstance(m, EvoNormSample2d):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.v.fill_(1.0)
            elif isinstance(m, XSlot):
                p = init_xslot_params(g, m.cfg)
                m.initial_slots.copy_(p["initial_slots"])
                for layer, src in zip((x for x in m.to_k if isinstance(x, nn.Linear)),
                                      p["to_k"]):
                    layer.weight.copy_(src["weight"])
                    layer.bias.copy_(src["bias"])
                for name, key in (("weight_ih_l0", "w_ih"), ("weight_hh_l0", "w_hh"),
                                  ("bias_ih_l0", "b_ih"), ("bias_hh_l0", "b_hh")):
                    getattr(m.gru, name).copy_(p["gru"][key])
            elif isinstance(m, nn.Linear) and m not in in_slot:
                _variance_scaling_(m.weight, 1.0, m.in_features, g)
                m.bias.zero_()


def build_slot_model(cfg, fused_slot: bool = False, device="cuda",
                     generator: Optional[torch.Generator] = None,
                     compute_dtype: Optional[torch.dtype] = None,
                     backbone_kwargs: Optional[dict] = None) -> SlotModel:
    """Build the SlotModel of a ScouterConfig in eval mode on ``device``.

    - MNIST swaps the stem conv for Conv(1->64, 3x3, s2, p1)
    - slot mode reads the backbone's features (no classifier is built)
    - no-slot mode keeps the backbone's ``num_classes`` classifier
    - ``compute_dtype`` (e.g. bf16, serving and training) keeps the
      backbone's parameters and BatchNorm statistics f32 and runs its convs,
      BatchNorms and classifier in it, as the JAX package's
      ``build_slot_model(cfg, dtype=...)`` (flax's ``dtype`` over f32
      ``param_dtype``); the slot head computes in f32 unless
      ``cfg.slot_head_dtype == 'compute'``, where it computes in it too, its
      parameters f32 and cast at use (so every state dict is f32)
    - ``fused_slot`` runs the xSlot loop through the CUDA kernel
      (``ops.slot_kernel``); ``generator`` seeds the init (default: cfg.seed)
    - ``backbone_kwargs`` go to the backbone's factory as they are (e.g.
      ``output_stride``, ``s2d_stem``, ``drop_rate``)
    - ``device="meta"`` builds the structure alone, with no init and no
      memory (to plan a layout, ``parallel/tp.py``)
    """
    if str(device) == "meta":
        with torch.device("meta"):
            return build_slot_model(cfg, fused_slot, "cpu", generator, compute_dtype,
                                    backbone_kwargs)
    dev = resolve_device(device)
    mnist = cfg.dataset == "MNIST"
    backbone = create_model(cfg.model, num_classes=0 if cfg.use_slot else cfg.num_classes,
                            in_chans=1 if mnist else 3, mnist_stem=mnist,
                            compute_dtype=compute_dtype, **(backbone_kwargs or {}))
    head_compute = (compute_dtype is not None and cfg.use_slot
                    and cfg.slot_head_dtype == "compute")
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
        head_dtype=compute_dtype if head_compute else None,
    )
    if next(model.parameters()).is_meta:
        return model.eval()
    init_weights(model, generator or torch.Generator().manual_seed(cfg.seed))
    return model.eval().to(dev)
