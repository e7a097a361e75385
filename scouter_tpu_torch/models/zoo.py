"""Registered backbone entrypoints the port carries (counterpart of
``scouter_tpu/models/zoo.py``): resnet10/18 and resnest14d/26d/50d. The other
families of the JAX zoo are still to be ported (ROADMAP.md)."""

from __future__ import annotations

from .registry import register_model
from .resnet import ResNet


@register_model
def resnet10(num_classes=1000, in_chans=3, **kw):
    """Minimal 4-stage BasicBlock net, the fast model of the tests."""
    return ResNet(block="basic", layers=(1, 1, 1, 1), num_classes=num_classes,
                  in_chans=in_chans, **kw)


@register_model
def resnet18(num_classes=1000, in_chans=3, **kw):
    return ResNet(block="basic", layers=(2, 2, 2, 2), num_classes=num_classes,
                  in_chans=in_chans, **kw)


def _resnest(layers, stem_width, num_classes, in_chans, **kw):
    return ResNet(
        block="resnest", layers=layers, stem_type="deep", stem_width=stem_width,
        avg_down=True, base_width=64, cardinality=1, radix=2, avd=True,
        avd_first=False, num_classes=num_classes, in_chans=in_chans, **kw,
    )


@register_model
def resnest14d(num_classes=1000, in_chans=3, **kw):
    return _resnest((1, 1, 1, 1), 32, num_classes, in_chans, **kw)


@register_model
def resnest26d(num_classes=1000, in_chans=3, **kw):
    return _resnest((2, 2, 2, 2), 32, num_classes, in_chans, **kw)


@register_model
def resnest50d(num_classes=1000, in_chans=3, **kw):
    return _resnest((3, 4, 6, 3), 32, num_classes, in_chans, **kw)
