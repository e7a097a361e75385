"""Pointing-game reference models (counterpart of
``scouter_tpu/explain/benchmark_models.py``; the capability of
``torchray/benchmark/models.py:36-434``).

The caffe-converted VGG16 / ResNet50 classifiers fine-tuned on VOC-2007 (20
classes) / COCO-2014 (80 classes), with the reference's fixups to the
torchvision graphs:

- every max pool in ceil mode (``_fix_caffe_maxpool``, models.py:50-53);
- VGG16: classifier keys remapped around the dropouts, the first conv
  BGR -> RGB (``_load_caffe_vgg16``, models.py:56-82);
- ResNet50: a biased conv1, a stem pool without padding, the stride on each
  stage's first 1x1 (``_load_caffe_resnet50``, models.py:113-151), bn and
  downsample key renames, BGR -> RGB, and optionally ``make_bn_positive``
  (models.py:137-150).

The modules carry torchvision's names, so a converted checkpoint loads with
``load_state_dict``; their ReLUs and residual adds go through ``models.act``
and their convs and BatchNorms are ``models.layers``', as in JAX.
:func:`get_model` loads a LOCAL ``.pth.tar`` (no download).
``convert_to_fully_convolutional`` reshapes the stored classifier into
convolutions at call time (``_caffe_vgg16_to_fc`` / ``_caffe_resnet50_to_fc``,
models.py:85-110, 154-186). :func:`get_transform` is the caffe
preprocessing (models.py:337-434).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models import act, init_weights
from ..models.layers import batch_norm, conv2d
from ._resize import resize_bilinear

__all__ = ["CaffeVGG16", "CaffeResNet50", "get_model", "get_transform",
           "convert_caffe_checkpoint", "NUM_CLASSES"]

NUM_CLASSES = {"voc": 20, "coco": 80}  # models.py:277-281

# caffe BGR channel means (models.py:365)
_BGR_MEAN = (103.939, 116.779, 123.68)


class _Relu(nn.Module):
    def forward(self, x):
        return act.relu(x)


class _MaxPoolCeil(nn.Module):
    """torch MaxPool2d(..., ceil_mode=True), the caffe pooling grid."""

    def __init__(self, k: int, s: int, p: int = 0):
        super().__init__()
        self.k, self.s, self.p = k, s, p

    def forward(self, x):
        return F.max_pool2d(x, self.k, self.s, self.p, ceil_mode=True)


# torchvision vgg16 'D': module indices of the convs inside ``features``
_VGG16_CONVS = ((0, 64), (2, 64), (5, 128), (7, 128), (10, 256), (12, 256),
                (14, 256), (17, 512), (19, 512), (21, 512), (24, 512),
                (26, 512), (28, 512))
_VGG16_POOL_AFTER = {2, 7, 14, 21, 28}


class CaffeVGG16(nn.Module):
    """torchvision VGG16 with the caffe fixups, its modules at torchvision's
    indices (features.0 ... features.30, classifier.0/3/6; dropout is the
    identity at inference). The dense classifier multiplies plainly, as
    JAX's ``x @ kernel``; ``fully_conv`` runs it as 7x7 and 1x1 convs
    (``_caffe_vgg16_to_fc``)."""

    def __init__(self, num_classes: int = 20, fully_conv: bool = False):
        super().__init__()
        self.num_classes, self.fully_conv = num_classes, fully_conv
        layers, in_c = [], 3
        for idx, chs in _VGG16_CONVS:
            layers += [conv2d(in_c, chs, 3, padding=1, bias=True), _Relu()]
            if idx in _VGG16_POOL_AFTER:
                layers.append(_MaxPoolCeil(2, 2))
            in_c = chs
        self.features = nn.Sequential(*layers)
        self.classifier = nn.Sequential(
            nn.Linear(512 * 7 * 7, 4096), _Relu(), nn.Identity(),
            nn.Linear(4096, 4096), _Relu(), nn.Identity(),
            nn.Linear(4096, num_classes))

    def forward(self, x, features_only: bool = False):
        x = self.features(x)
        if features_only:
            return x
        linears = [self.classifier[i] for i in (0, 3, 6)]
        if self.fully_conv:
            for i, lin in enumerate(linears):
                w = lin.weight.view(-1, 512, 7, 7) if i == 0 else lin.weight[:, :, None, None]
                x = act.linear(F.conv2d, x, w.to(x.dtype), lin.bias.to(x.dtype))
                if i < 2:
                    x = act.relu(x)
            return x.permute(0, 2, 3, 1)  # (B, h, w, classes), JAX's layout
        # torchvision's AdaptiveAvgPool2d((7, 7)) is the identity at 224 px
        assert x.shape[2:] == (7, 7), "non-224 input requires fully_conv=True"
        x = x.flatten(1)
        for i, lin in enumerate(linears):
            x = x @ lin.weight.t().to(x.dtype) + lin.bias.to(x.dtype)
            if i < 2:
                x = act.relu(x)
        return x


class _CaffeBottleneck(nn.Module):
    """torchvision Bottleneck with the caffe stride placement: the stride on
    the 1x1 conv1, conv2 at stride 1 (models.py:119-121)."""

    def __init__(self, in_c: int, planes: int, stride: int = 1, has_downsample: bool = False):
        super().__init__()
        self.conv1 = conv2d(in_c, planes, 1, stride=stride, padding=0)
        self.bn1 = batch_norm(planes)
        self.conv2 = conv2d(planes, planes, 3, padding=1)
        self.bn2 = batch_norm(planes)
        self.conv3 = conv2d(planes, planes * 4, 1, padding=0)
        self.bn3 = batch_norm(planes * 4)
        self.downsample = (nn.Sequential(conv2d(in_c, planes * 4, 1, stride=stride, padding=0),
                                         batch_norm(planes * 4))
                           if has_downsample else None)

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        out = act.relu(self.bn1(self.conv1(x)))
        out = act.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return act.relu(act.residual_add(out, residual))


class CaffeResNet50(nn.Module):
    """torchvision resnet50 with the caffe patches (models.py:113-133): a
    biased conv1, a ceil-mode stem pool without padding, the stride on each
    block's conv1. ``stop_after``/``start_from`` ('layer1'..'layer4') split
    the forward at a stage boundary, the zoo ``ResNet``'s contract, for
    layer-targeted attribution (excitation backprop, IBA)."""

    def __init__(self, num_classes: int = 20, fully_conv: bool = False):
        super().__init__()
        self.num_classes, self.fully_conv = num_classes, fully_conv
        self.conv1 = conv2d(3, 64, 7, stride=2, padding=3, bias=True)
        self.bn1 = batch_norm(64)
        in_c = 64
        for stage, (planes, blocks) in enumerate([(64, 3), (128, 4), (256, 6), (512, 3)],
                                                 start=1):
            layer = []
            for b in range(blocks):
                stride = 2 if (stage > 1 and b == 0) else 1
                layer.append(_CaffeBottleneck(in_c, planes, stride, has_downsample=(b == 0)))
                in_c = planes * 4
            self.add_module(f"layer{stage}", nn.Sequential(*layer))
        self.fc = nn.Linear(2048, num_classes)

    def forward(self, x, features_only: bool = False, stop_after: Optional[str] = None,
                start_from: Optional[str] = None):
        resume_after = int(start_from[-1]) if start_from is not None else 0
        if start_from is None:
            x = act.relu(self.bn1(self.conv1(x)))
            x = F.max_pool2d(x, 3, 2, 0, ceil_mode=True)  # padding dropped (models.py:116-117)
        for stage in range(resume_after + 1, 5):
            x = getattr(self, f"layer{stage}")(x)
            if stop_after == f"layer{stage}":
                return x
        if features_only:
            return x
        w, b = self.fc.weight, self.fc.bias
        if self.fully_conv:
            # fc -> 1x1 conv, the adaptive average pool kept (models.py:154-186)
            x = x.mean(dim=(2, 3), keepdim=True)
            out = act.linear(F.conv2d, x, w[:, :, None, None].to(x.dtype), b.to(x.dtype))
            return out.permute(0, 2, 3, 1)
        return x.mean(dim=(2, 3)) @ w.t().to(x.dtype) + b.to(x.dtype)


# --------------------------------------------------------------------------
# checkpoint conversion (the caffe fixups applied to the torch state dict)
# --------------------------------------------------------------------------

_VGG_CLASSIFIER_REMAP = {  # models.py:60-67
    "classifier.2.weight": "classifier.3.weight",
    "classifier.2.bias": "classifier.3.bias",
    "classifier.4.weight": "classifier.6.weight",
    "classifier.4.bias": "classifier.6.bias",
}


def convert_caffe_checkpoint(arch: str, checkpoint: Mapping[str, Any],
                             make_bn_positive: bool = False) -> Dict[str, torch.Tensor]:
    """A caffe checkpoint -> the state dict of :class:`CaffeVGG16` /
    :class:`CaffeResNet50`, with the reference's fixups."""
    sd = {k: torch.as_tensor(v).detach().cpu() for k, v in checkpoint.items()}
    if arch == "vgg16":
        sd = {_VGG_CLASSIFIER_REMAP.get(k, k): v for k, v in sd.items()}
        sd["features.0.weight"] = sd["features.0.weight"][:, [2, 1, 0]]  # BGR->RGB
        return sd
    if arch == "resnet50":
        def rename(name):  # models.py:124-127
            name = re.sub(r"bn(\d)\.(0|1)\.(.*)", r"bn\1.\3", name)
            return re.sub(r"downsample\.(\d)\.(0|1)\.(.*)", r"downsample.\1.\3", name)

        sd = {rename(k): v for k, v in sd.items()}
        sd["conv1.weight"] = sd["conv1.weight"][:, [2, 1, 0]]  # BGR->RGB
        if make_bn_positive:  # EBP sign folding (models.py:137-150)
            # state-dict order pairs each BN with the conv just before it,
            # like the reference's modules() walk
            conv_key = None
            for k in list(sd):
                v = sd[k]
                if k.endswith(".weight") and v.dim() == 4:
                    conv_key = k
                    continue
                base = k[: -len(".weight")]
                if k.endswith(".weight") and v.dim() == 1 and base + ".running_mean" in sd:
                    sign = torch.sign(v)
                    sign[sign == 0] = 1.0
                    sd[k] = v * sign
                    sd[base + ".running_mean"] = sd[base + ".running_mean"] * sign
                    if conv_key is not None:
                        sd[conv_key] = sd[conv_key] * sign[:, None, None, None]
                        cb = conv_key[: -len(".weight")] + ".bias"
                        if cb in sd:
                            sd[cb] = sd[cb] * sign
        for k in [k for k in sd if k.endswith("running_mean")]:
            sd.setdefault(k[: -len("running_mean")] + "num_batches_tracked",
                          torch.tensor(0, dtype=torch.long))
        return sd
    raise ValueError(f"unsupported arch {arch!r} (vgg16 | resnet50)")


def get_model(arch: str = "vgg16", dataset: str = "voc",
              convert_to_fully_convolutional: bool = False,
              weights_path: Optional[str] = None, make_bn_positive: bool = False,
              device="cuda", seed: int = 0):
    """``torchray.benchmark.models.get_model`` (models.py:251-334) on
    ``device``, in eval mode. Returns ``(module, state_dict)``: with
    ``weights_path`` (a local copy of the published ``.pth.tar``) the
    converted checkpoint, loaded into the module; without one None, and the
    module keeps a random init from ``seed``."""
    from ..core.device import resolve_device

    key = "voc" if "voc" in dataset else "coco" if "coco" in dataset else None
    if key is None:
        raise ValueError("dataset must contain 'voc' or 'coco' "
                         "(imagenet models come from the main zoo)")
    num_classes = NUM_CLASSES[key]
    if arch == "vgg16":
        module = CaffeVGG16(num_classes=num_classes, fully_conv=convert_to_fully_convolutional)
    elif arch == "resnet50":
        module = CaffeResNet50(num_classes=num_classes,
                               fully_conv=convert_to_fully_convolutional)
    else:
        raise ValueError("only vgg16 / resnet50 have published caffe weights")
    dev = resolve_device(device)
    init_weights(module, torch.Generator().manual_seed(seed))
    state_dict = None
    if weights_path is not None:
        checkpoint = torch.load(weights_path, map_location="cpu", weights_only=False)
        if isinstance(checkpoint, dict) and "state_dict" in checkpoint:
            checkpoint = checkpoint["state_dict"]
        state_dict = convert_caffe_checkpoint(arch, checkpoint,
                                              make_bn_positive=make_bn_positive)
        module.load_state_dict(state_dict)
    return module.eval().to(dev), state_dict


def get_transform(dataset: str = "imagenet", size=224):
    """Preprocessing (models.py:337-434) of float RGB [0, 1] (H, W, C)
    images, on their device. imagenet: shorter-side resize and the standard
    normalisation; voc/coco: shorter-side resize and caffe's x*255 - mean
    (the BGR means in RGB order). The resize is ``jax.image.resize``'s
    bilinear (antialiased when it shrinks)."""
    if "imagenet" in dataset:
        mean = np.array([0.485, 0.456, 0.406], np.float32)
        std = np.array([0.229, 0.224, 0.225], np.float32)
    else:
        mean = np.array([m / 255.0 for m in reversed(_BGR_MEAN)], np.float32)
        std = np.array([1 / 255.0] * 3, np.float32)

    def transform(img) -> torch.Tensor:
        x = torch.as_tensor(img).to(torch.float32)
        h, w = x.shape[:2]
        if isinstance(size, int):
            oh, ow = (int(size * h / w), size) if w < h else (size, int(size * w / h))
        else:
            oh, ow = size
        x = resize_bilinear(x.permute(2, 0, 1), (oh, ow)).permute(1, 2, 0)
        return (x - torch.from_numpy(mean).to(x.device)) / torch.from_numpy(std).to(x.device)

    return transform
