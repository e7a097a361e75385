"""Registered backbone entrypoints (counterpart of ``scouter_tpu/models/zoo.py``):
the whole ResNet family of the JAX zoo, under the same names, with the
same factories and defaults.

Configurations mirror the timm entrypoints the reference exposes:
- resnet family: ``timm/models/resnet.py:512+`` ('d' variants = deep stem +
  avg_down), with the SE/ECA, anti-aliased and pruned variants
- gluon variants: ``timm/models/gluon_resnet.py``
- res2net, sknet and resnest families: ``timm/models/{res2net,sknet,resnest}.py``
- the tv_/ig_/ssl_/swsl_ aliases share the plain architectures and differ
  only in where the reference's pretrained weights came from

The other backbone families of the JAX registry are still to be ported
(ROADMAP.md).
"""

from __future__ import annotations

from .pruned import load_pruned_widths
from .registry import register_model
from .resnet import ResNet

__all__ = []  # the entrypoints are reached through the registry


# ---------------------------------------------------------------- resnet family
@register_model
def resnet10(num_classes=1000, in_chans=3, **kw):
    """Minimal 4-stage BasicBlock net, the fast model of the tests."""
    return ResNet(block="basic", layers=(1, 1, 1, 1), num_classes=num_classes,
                  in_chans=in_chans, **kw)


@register_model
def resnet18(num_classes=1000, in_chans=3, **kw):
    return ResNet(block="basic", layers=(2, 2, 2, 2), num_classes=num_classes,
                  in_chans=in_chans, **kw)


@register_model
def resnet34(num_classes=1000, in_chans=3, **kw):
    return ResNet(block="basic", layers=(3, 4, 6, 3), num_classes=num_classes,
                  in_chans=in_chans, **kw)


@register_model
def resnet26(num_classes=1000, in_chans=3, **kw):
    return ResNet(block="bottleneck", layers=(2, 2, 2, 2), num_classes=num_classes,
                  in_chans=in_chans, **kw)


@register_model
def resnet26d(num_classes=1000, in_chans=3, **kw):
    return ResNet(block="bottleneck", layers=(2, 2, 2, 2), stem_width=32,
                  stem_type="deep", avg_down=True, num_classes=num_classes,
                  in_chans=in_chans, **kw)


@register_model
def resnet50(num_classes=1000, in_chans=3, **kw):
    return ResNet(block="bottleneck", layers=(3, 4, 6, 3), num_classes=num_classes,
                  in_chans=in_chans, **kw)


@register_model
def resnet50d(num_classes=1000, in_chans=3, **kw):
    return ResNet(block="bottleneck", layers=(3, 4, 6, 3), stem_width=32,
                  stem_type="deep", avg_down=True, num_classes=num_classes,
                  in_chans=in_chans, **kw)


@register_model
def resnet101(num_classes=1000, in_chans=3, **kw):
    return ResNet(block="bottleneck", layers=(3, 4, 23, 3), num_classes=num_classes,
                  in_chans=in_chans, **kw)


@register_model
def resnet152(num_classes=1000, in_chans=3, **kw):
    return ResNet(block="bottleneck", layers=(3, 8, 36, 3), num_classes=num_classes,
                  in_chans=in_chans, **kw)


@register_model
def resnext50_32x4d(num_classes=1000, in_chans=3, **kw):
    return ResNet(block="bottleneck", layers=(3, 4, 6, 3), cardinality=32,
                  base_width=4, num_classes=num_classes, in_chans=in_chans, **kw)


@register_model
def resnext101_32x8d(num_classes=1000, in_chans=3, **kw):
    return ResNet(block="bottleneck", layers=(3, 4, 23, 3), cardinality=32,
                  base_width=8, num_classes=num_classes, in_chans=in_chans, **kw)


@register_model
def wide_resnet50_2(num_classes=1000, in_chans=3, **kw):
    return ResNet(block="bottleneck", layers=(3, 4, 6, 3), base_width=128,
                  num_classes=num_classes, in_chans=in_chans, **kw)


@register_model
def wide_resnet101_2(num_classes=1000, in_chans=3, **kw):
    return ResNet(block="bottleneck", layers=(3, 4, 23, 3), base_width=128,
                  num_classes=num_classes, in_chans=in_chans, **kw)


@register_model
def seresnext26d_32x4d(num_classes=1000, in_chans=3, **kw):
    return ResNet(block="bottleneck", layers=(2, 2, 2, 2), cardinality=32,
                  base_width=4, stem_width=32, stem_type="deep", avg_down=True,
                  attn="se", num_classes=num_classes, in_chans=in_chans, **kw)


@register_model
def ecaresnet18(num_classes=1000, in_chans=3, **kw):
    return ResNet(block="basic", layers=(2, 2, 2, 2), attn="eca",
                  num_classes=num_classes, in_chans=in_chans, **kw)


@register_model
def ecaresnet50(num_classes=1000, in_chans=3, **kw):
    return ResNet(block="bottleneck", layers=(3, 4, 6, 3), attn="eca",
                  num_classes=num_classes, in_chans=in_chans, **kw)


@register_model
def ecaresnet50d(num_classes=1000, in_chans=3, **kw):
    return ResNet(block="bottleneck", layers=(3, 4, 6, 3), stem_width=32,
                  stem_type="deep", avg_down=True, attn="eca",
                  num_classes=num_classes, in_chans=in_chans, **kw)


@register_model
def ecaresnet50d_pruned(num_classes=1000, in_chans=3, **kw):
    """ResNet-50-D + eca with pruned channel widths (timm resnet.py:1080-1096,
    surgery table from timm/models/pruned/ecaresnet50d_pruned.txt)."""
    return ResNet(block="bottleneck", layers=(3, 4, 6, 3), stem_width=32,
                  stem_type="deep", avg_down=True, attn="eca",
                  widths=load_pruned_widths("ecaresnet50d_pruned"),
                  num_classes=num_classes, in_chans=in_chans, **kw)


@register_model
def ecaresnet101d_pruned(num_classes=1000, in_chans=3, **kw):
    """ResNet-101-D + eca with pruned channel widths (timm resnet.py:1126-1142)."""
    return ResNet(block="bottleneck", layers=(3, 4, 23, 3), stem_width=32,
                  stem_type="deep", avg_down=True, attn="eca",
                  widths=load_pruned_widths("ecaresnet101d_pruned"),
                  num_classes=num_classes, in_chans=in_chans, **kw)


@register_model
def ecaresnetlight(num_classes=1000, in_chans=3, **kw):
    return ResNet(block="bottleneck", layers=(1, 1, 11, 3), stem_width=32,
                  avg_down=True, attn="eca",
                  num_classes=num_classes, in_chans=in_chans, **kw)


# ------------------------------------------------- gluon resnet variants
# (timm/models/gluon_resnet.py: the same universal ResNet with MXNet-style
#  stem/downsample configs — v1b plain, v1c deep stem, v1d deep+avg_down,
#  v1s deep stem width 64)
def _gluon(layers, block, num_classes, in_chans, stem="", stem_w=64, avg=False, **kw):
    return ResNet(block=block, layers=layers, stem_type=stem, stem_width=stem_w,
                  avg_down=avg, num_classes=num_classes, in_chans=in_chans, **kw)


@register_model
def gluon_resnet50_v1b(num_classes=1000, in_chans=3, **kw):
    return _gluon((3, 4, 6, 3), "bottleneck", num_classes, in_chans, **kw)


@register_model
def gluon_resnet50_v1c(num_classes=1000, in_chans=3, **kw):
    return _gluon((3, 4, 6, 3), "bottleneck", num_classes, in_chans,
                  stem="deep", stem_w=32, **kw)


@register_model
def gluon_resnet50_v1d(num_classes=1000, in_chans=3, **kw):
    return _gluon((3, 4, 6, 3), "bottleneck", num_classes, in_chans,
                  stem="deep", stem_w=32, avg=True, **kw)


@register_model
def gluon_resnet50_v1s(num_classes=1000, in_chans=3, **kw):
    return _gluon((3, 4, 6, 3), "bottleneck", num_classes, in_chans,
                  stem="deep", stem_w=64, **kw)


@register_model
def gluon_resnet101_v1b(num_classes=1000, in_chans=3, **kw):
    return _gluon((3, 4, 23, 3), "bottleneck", num_classes, in_chans, **kw)


@register_model
def gluon_resnet101_v1d(num_classes=1000, in_chans=3, **kw):
    return _gluon((3, 4, 23, 3), "bottleneck", num_classes, in_chans,
                  stem="deep", stem_w=32, avg=True, **kw)


@register_model
def gluon_resnet152_v1b(num_classes=1000, in_chans=3, **kw):
    return _gluon((3, 8, 36, 3), "bottleneck", num_classes, in_chans, **kw)


@register_model
def gluon_resnext50_32x4d(num_classes=1000, in_chans=3, **kw):
    return ResNet(block="bottleneck", layers=(3, 4, 6, 3), cardinality=32,
                  base_width=4, num_classes=num_classes, in_chans=in_chans, **kw)


# --------------------------------------------------------------- res2net family
@register_model
def res2net50_26w_4s(num_classes=1000, in_chans=3, **kw):
    return ResNet(block="res2net", layers=(3, 4, 6, 3), base_width=26, scale=4,
                  num_classes=num_classes, in_chans=in_chans, **kw)


@register_model
def res2net50_26w_6s(num_classes=1000, in_chans=3, **kw):
    return ResNet(block="res2net", layers=(3, 4, 6, 3), base_width=26, scale=6,
                  num_classes=num_classes, in_chans=in_chans, **kw)


@register_model
def res2net50_26w_8s(num_classes=1000, in_chans=3, **kw):
    return ResNet(block="res2net", layers=(3, 4, 6, 3), base_width=26, scale=8,
                  num_classes=num_classes, in_chans=in_chans, **kw)


@register_model
def res2net50_48w_2s(num_classes=1000, in_chans=3, **kw):
    return ResNet(block="res2net", layers=(3, 4, 6, 3), base_width=48, scale=2,
                  num_classes=num_classes, in_chans=in_chans, **kw)


@register_model
def res2net50_14w_8s(num_classes=1000, in_chans=3, **kw):
    return ResNet(block="res2net", layers=(3, 4, 6, 3), base_width=14, scale=8,
                  num_classes=num_classes, in_chans=in_chans, **kw)


@register_model
def res2net101_26w_4s(num_classes=1000, in_chans=3, **kw):
    return ResNet(block="res2net", layers=(3, 4, 23, 3), base_width=26, scale=4,
                  num_classes=num_classes, in_chans=in_chans, **kw)


@register_model
def res2next50(num_classes=1000, in_chans=3, **kw):
    return ResNet(block="res2net", layers=(3, 4, 6, 3), base_width=4, scale=4,
                  cardinality=8, num_classes=num_classes, in_chans=in_chans, **kw)


# ----------------------------------------------------------------- sknet family
@register_model
def skresnet18(num_classes=1000, in_chans=3, **kw):
    return ResNet(block="sk_basic", layers=(2, 2, 2, 2), sk_min_attn_channels=16,
                  sk_attn_reduction=8, sk_split_input=True,
                  num_classes=num_classes, in_chans=in_chans, **kw)


@register_model
def skresnet34(num_classes=1000, in_chans=3, **kw):
    return ResNet(block="sk_basic", layers=(3, 4, 6, 3), sk_min_attn_channels=16,
                  sk_attn_reduction=8, sk_split_input=True,
                  num_classes=num_classes, in_chans=in_chans, **kw)


@register_model
def skresnet50(num_classes=1000, in_chans=3, **kw):
    return ResNet(block="sk_bottleneck", layers=(3, 4, 6, 3), sk_split_input=True,
                  num_classes=num_classes, in_chans=in_chans, **kw)


@register_model
def skresnext50_32x4d(num_classes=1000, in_chans=3, **kw):
    return ResNet(block="sk_bottleneck", layers=(3, 4, 6, 3), cardinality=32,
                  base_width=4, num_classes=num_classes, in_chans=in_chans, **kw)


# --------------------------------------------------------------- resnest family
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


@register_model
def resnest101e(num_classes=1000, in_chans=3, **kw):
    return _resnest((3, 4, 23, 3), 64, num_classes, in_chans, **kw)


@register_model
def resnest200e(num_classes=1000, in_chans=3, **kw):
    return _resnest((3, 24, 36, 3), 64, num_classes, in_chans, **kw)


@register_model
def resnest269e(num_classes=1000, in_chans=3, **kw):
    """ResNeSt-269e (timm/models/resnest.py:225-237)."""
    return _resnest((3, 30, 48, 8), 64, num_classes, in_chans, **kw)


@register_model
def resnest50d_1s4x24d(num_classes=1000, in_chans=3, **kw):
    """ResNeSt-50 fast 1s4x24d ablation (resnest.py:256-266): radix 1
    (sigmoid-gated split attn), cardinality 4, width 24, avd_first."""
    return ResNet(block="resnest", layers=(3, 4, 6, 3), stem_type="deep",
                  stem_width=32, avg_down=True, base_width=24, cardinality=4,
                  radix=1, avd=True, avd_first=True,
                  num_classes=num_classes, in_chans=in_chans, **kw)


@register_model
def resnest50d_4s2x40d(num_classes=1000, in_chans=3, **kw):
    """ResNeSt-50 fast 4s2x40d ablation (resnest.py:240-252)."""
    return ResNet(block="resnest", layers=(3, 4, 6, 3), stem_type="deep",
                  stem_width=32, avg_down=True, base_width=40, cardinality=2,
                  radix=4, avd=True, avd_first=True,
                  num_classes=num_classes, in_chans=in_chans, **kw)


# ------------------------------------------------ resnext + weight-alias zoo
# (timm/models/resnet.py:614-975: tv_/ig_/ssl_/swsl_ entrypoints share the
#  plain architectures and differ only in pretrained weight provenance)
@register_model
def resnext101_32x4d(num_classes=1000, in_chans=3, **kw):
    return ResNet(block="bottleneck", layers=(3, 4, 23, 3), cardinality=32,
                  base_width=4, num_classes=num_classes, in_chans=in_chans, **kw)


@register_model
def resnext101_64x4d(num_classes=1000, in_chans=3, **kw):
    return ResNet(block="bottleneck", layers=(3, 4, 23, 3), cardinality=64,
                  base_width=4, num_classes=num_classes, in_chans=in_chans, **kw)


@register_model
def resnext50d_32x4d(num_classes=1000, in_chans=3, **kw):
    """ResNeXt50-D (resnet.py:683-695): deep stem, avg_down."""
    return ResNet(block="bottleneck", layers=(3, 4, 6, 3), cardinality=32,
                  base_width=4, stem_width=32, stem_type="deep", avg_down=True,
                  num_classes=num_classes, in_chans=in_chans, **kw)


def _alias_basic(name, layers):
    def fn(num_classes=1000, in_chans=3, **kw):
        return ResNet(block="basic", layers=layers, num_classes=num_classes,
                      in_chans=in_chans, **kw)

    fn.__name__ = name
    register_model(fn)


def _alias_bneck(name, layers, cardinality=1, base_width=64):
    def fn(num_classes=1000, in_chans=3, **kw):
        return ResNet(block="bottleneck", layers=layers, cardinality=cardinality,
                      base_width=base_width, num_classes=num_classes,
                      in_chans=in_chans, **kw)

    fn.__name__ = name
    register_model(fn)


_alias_basic("tv_resnet34", (3, 4, 6, 3))
_alias_bneck("tv_resnet50", (3, 4, 6, 3))
_alias_bneck("tv_resnext50_32x4d", (3, 4, 6, 3), 32, 4)
for _w in (8, 16, 32, 48):
    _alias_bneck(f"ig_resnext101_32x{_w}d", (3, 4, 23, 3), 32, _w)
for _p in ("ssl", "swsl"):
    _alias_basic(f"{_p}_resnet18", (2, 2, 2, 2))
    _alias_bneck(f"{_p}_resnet50", (3, 4, 6, 3))
    _alias_bneck(f"{_p}_resnext50_32x4d", (3, 4, 6, 3), 32, 4)
    for _w in (4, 8, 16):
        _alias_bneck(f"{_p}_resnext101_32x{_w}d", (3, 4, 23, 3), 32, _w)


@register_model
def resnetblur18(num_classes=1000, in_chans=3, **kw):
    """ResNet-18 with BlurPool anti-aliasing (resnet.py:1147-1156)."""
    return ResNet(block="basic", layers=(2, 2, 2, 2), aa=True,
                  num_classes=num_classes, in_chans=in_chans, **kw)


@register_model
def resnetblur50(num_classes=1000, in_chans=3, **kw):
    """ResNet-50 with BlurPool anti-aliasing (resnet.py:1160-1169)."""
    return ResNet(block="bottleneck", layers=(3, 4, 6, 3), aa=True,
                  num_classes=num_classes, in_chans=in_chans, **kw)


# ----------------------------------------- tiered-stem SE/ECA resnext variants
@register_model
def seresnext26t_32x4d(num_classes=1000, in_chans=3, **kw):
    """SE-ResNeXt-26-T (resnet.py:988-1002): deep tiered 24/48/64 stem."""
    return ResNet(block="bottleneck", layers=(2, 2, 2, 2), cardinality=32,
                  base_width=4, stem_width=32, stem_type="deep_tiered",
                  avg_down=True, attn="se",
                  num_classes=num_classes, in_chans=in_chans, **kw)


@register_model
def seresnext26tn_32x4d(num_classes=1000, in_chans=3, **kw):
    """SE-ResNeXt-26-TN (resnet.py:1005-1019): narrow tiered 24/32/64 stem."""
    return ResNet(block="bottleneck", layers=(2, 2, 2, 2), cardinality=32,
                  base_width=4, stem_width=32, stem_type="deep_tiered_narrow",
                  avg_down=True, attn="se",
                  num_classes=num_classes, in_chans=in_chans, **kw)


@register_model
def ecaresnext26tn_32x4d(num_classes=1000, in_chans=3, **kw):
    """ECA-ResNeXt-26-TN (resnet.py:1022-1038)."""
    return ResNet(block="bottleneck", layers=(2, 2, 2, 2), cardinality=32,
                  base_width=4, stem_width=32, stem_type="deep_tiered_narrow",
                  avg_down=True, attn="eca",
                  num_classes=num_classes, in_chans=in_chans, **kw)


@register_model
def ecaresnet101d(num_classes=1000, in_chans=3, **kw):
    """ResNet-101-D with eca (resnet.py:1115-1125)."""
    return ResNet(block="bottleneck", layers=(3, 4, 23, 3), stem_width=32,
                  stem_type="deep", avg_down=True, attn="eca",
                  num_classes=num_classes, in_chans=in_chans, **kw)


@register_model
def skresnet50d(num_classes=1000, in_chans=3, **kw):
    """SK-ResNet-50-D (sknet.py:206-222): deep stem, avg_down, split input."""
    return ResNet(block="sk_bottleneck", layers=(3, 4, 6, 3), stem_width=32,
                  stem_type="deep", avg_down=True, sk_split_input=True,
                  num_classes=num_classes, in_chans=in_chans, **kw)


# --------------------------------------------------- remaining gluon variants
@register_model
def gluon_resnet18_v1b(num_classes=1000, in_chans=3, **kw):
    return ResNet(block="basic", layers=(2, 2, 2, 2), num_classes=num_classes,
                  in_chans=in_chans, **kw)


@register_model
def gluon_resnet34_v1b(num_classes=1000, in_chans=3, **kw):
    return ResNet(block="basic", layers=(3, 4, 6, 3), num_classes=num_classes,
                  in_chans=in_chans, **kw)


@register_model
def gluon_resnet50_v1e(num_classes=1000, in_chans=3, **kw):
    """v1e = deep stem width 64 + avg_down (gluon_resnet.py:192-199)."""
    return _gluon((3, 4, 6, 3), "bottleneck", num_classes, in_chans,
                  stem="deep", stem_w=64, avg=True, **kw)


@register_model
def gluon_resnet101_v1c(num_classes=1000, in_chans=3, **kw):
    return _gluon((3, 4, 23, 3), "bottleneck", num_classes, in_chans,
                  stem="deep", stem_w=32, **kw)


@register_model
def gluon_resnet101_v1e(num_classes=1000, in_chans=3, **kw):
    return _gluon((3, 4, 23, 3), "bottleneck", num_classes, in_chans,
                  stem="deep", stem_w=64, avg=True, **kw)


@register_model
def gluon_resnet101_v1s(num_classes=1000, in_chans=3, **kw):
    return _gluon((3, 4, 23, 3), "bottleneck", num_classes, in_chans,
                  stem="deep", stem_w=64, **kw)


@register_model
def gluon_resnet152_v1c(num_classes=1000, in_chans=3, **kw):
    return _gluon((3, 8, 36, 3), "bottleneck", num_classes, in_chans,
                  stem="deep", stem_w=32, **kw)


@register_model
def gluon_resnet152_v1d(num_classes=1000, in_chans=3, **kw):
    return _gluon((3, 8, 36, 3), "bottleneck", num_classes, in_chans,
                  stem="deep", stem_w=32, avg=True, **kw)


@register_model
def gluon_resnet152_v1e(num_classes=1000, in_chans=3, **kw):
    return _gluon((3, 8, 36, 3), "bottleneck", num_classes, in_chans,
                  stem="deep", stem_w=64, avg=True, **kw)


@register_model
def gluon_resnet152_v1s(num_classes=1000, in_chans=3, **kw):
    return _gluon((3, 8, 36, 3), "bottleneck", num_classes, in_chans,
                  stem="deep", stem_w=64, **kw)


@register_model
def gluon_resnext101_32x4d(num_classes=1000, in_chans=3, **kw):
    return ResNet(block="bottleneck", layers=(3, 4, 23, 3), cardinality=32,
                  base_width=4, num_classes=num_classes, in_chans=in_chans, **kw)


@register_model
def gluon_resnext101_64x4d(num_classes=1000, in_chans=3, **kw):
    return ResNet(block="bottleneck", layers=(3, 4, 23, 3), cardinality=64,
                  base_width=4, num_classes=num_classes, in_chans=in_chans, **kw)


@register_model
def gluon_seresnext50_32x4d(num_classes=1000, in_chans=3, **kw):
    """Universal-ResNet SE-ResNeXt (gluon_resnet.py:312-322)."""
    return ResNet(block="bottleneck", layers=(3, 4, 6, 3), cardinality=32,
                  base_width=4, attn="se",
                  num_classes=num_classes, in_chans=in_chans, **kw)


@register_model
def gluon_seresnext101_32x4d(num_classes=1000, in_chans=3, **kw):
    return ResNet(block="bottleneck", layers=(3, 4, 23, 3), cardinality=32,
                  base_width=4, attn="se",
                  num_classes=num_classes, in_chans=in_chans, **kw)


@register_model
def gluon_seresnext101_64x4d(num_classes=1000, in_chans=3, **kw):
    return ResNet(block="bottleneck", layers=(3, 4, 23, 3), cardinality=64,
                  base_width=4, attn="se",
                  num_classes=num_classes, in_chans=in_chans, **kw)


@register_model
def gluon_senet154(num_classes=1000, in_chans=3, **kw):
    """SENet-154 on the universal ResNet (gluon_resnet.py:355-365): deep stem
    (64/64/128), reduce_first=2, 3x3 downsample convs, SE attention."""
    return ResNet(block="bottleneck", layers=(3, 8, 36, 3), cardinality=64,
                  base_width=4, stem_type="deep", reduce_first=2,
                  down_kernel_size=3, attn="se",
                  num_classes=num_classes, in_chans=in_chans, **kw)
