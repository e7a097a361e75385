"""HRNet (HRNetV2 classification) in NCHW (counterpart of
``scouter_tpu/models/hrnet.py``, after ``timm/models/hrnet.py``).

Parallel branches at several resolutions, fused again and again
(HighResolutionModule :390-515): residual blocks per branch, then every
pair of branches joined, lower to higher by a 1x1 conv and a nearest
upsample, higher to lower by chains of stride-2 3x3 convs. Stages 2-4 add
a branch each through the transition layers (:605-630); the classification
head widens each resolution with a bottleneck, downsamples and sums them in
turn, and ends in a 1x1 conv to 2048 (:568-604). The blocks are the ResNet
family's. Module names are timm's (``stage2.0.branches.0.0.conv1``,
``stage3.0.fuse_layers.1.0.0.0``, ``transition1.1.0.0``,
``incre_modules.0.0``, ``downsamp_modules.0.0``, ``final_layer.0``,
``classifier``).
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn

from . import act
from .layers import (Conv2d, Linear, batch_norm, conv2d, global_avg_pool, head_dropout,
                     head_dtype)
from .registry import register_model
from .resnet import _BasicBlock, _Bottleneck, _Relu

__all__ = ["HighResolutionNet"]


def _block_layer(in_chs: int, block_kind: str, planes: int, blocks: int, dt,
                 stride: int = 1) -> nn.Sequential:
    cls = _Bottleneck if block_kind == "BOTTLENECK" else _BasicBlock
    expansion = 4 if block_kind == "BOTTLENECK" else 1
    mods = []
    for i in range(blocks):
        s = stride if i == 0 else 1
        needs = i == 0 and (s != 1 or in_chs != planes * expansion)
        mods.append(cls(in_chs, planes, stride=s, has_downsample=needs, avg_down=False,
                        compute_dtype=dt))
        in_chs = planes * expansion
    return nn.Sequential(*mods)


class _HRModule(nn.Module):
    def __init__(self, num_branches: int, block: str, num_blocks: Sequence[int],
                 in_channels: Sequence[int], num_channels: Sequence[int], compute_dtype=None):
        super().__init__()
        dt = compute_dtype
        expansion = 4 if block == "BOTTLENECK" else 1
        out_chs = [c * expansion for c in num_channels]
        self.num_branches = num_branches
        self.branches = nn.ModuleList(
            _block_layer(in_channels[i], block, num_channels[i], num_blocks[i], dt)
            for i in range(num_branches))
        self.fuse_layers = nn.ModuleList()
        if num_branches == 1:
            return
        for i in range(num_branches):
            row = nn.ModuleList()
            for j in range(num_branches):
                if j == i:
                    row.append(nn.Identity())
                elif j > i:
                    row.append(nn.Sequential(
                        conv2d(out_chs[j], out_chs[i], 1, padding=0, compute_dtype=dt),
                        batch_norm(out_chs[i], compute_dtype=dt),
                        nn.Upsample(scale_factor=2 ** (j - i), mode="nearest")))
                else:  # a chain of stride-2 3x3 convs
                    chain = []
                    for k in range(i - j):
                        last = k == i - j - 1
                        chs = out_chs[i] if last else out_chs[j]
                        chain.append(nn.Sequential(
                            conv2d(out_chs[j], chs, 3, stride=2, padding=1, compute_dtype=dt),
                            batch_norm(chs, compute_dtype=dt), *([] if last else [_Relu()])))
                    row.append(nn.Sequential(*chain))
            self.fuse_layers.append(row)

    def forward(self, xs):
        xs = [branch(x) for branch, x in zip(self.branches, xs)]
        if self.num_branches == 1:
            return xs
        fused = []
        for row in self.fuse_layers:
            y = None
            for layer, x in zip(row, xs):
                v = layer(x)
                y = v if y is None else y + v  # a plain sum in JAX's fuse (hrnet.py:90)
            fused.append(act.relu(y))
        return fused


class HighResolutionNet(nn.Module):
    """HRNet (``timm/models/hrnet.py:520-740``) of a ``cfg`` built by
    ``_wn_cfg``/``_stage``. ``num_classes=0`` builds no classifier;
    ``features_only`` returns the 2048-wide map after ``final_layer``."""

    def __init__(self, cfg: tuple, num_classes: int = 1000, in_chans: int = 3,
                 drop_rate: float = 0.0, mnist_stem: bool = False, compute_dtype=None):
        super().__init__()
        del mnist_stem  # the JAX family takes and ignores it
        dt = compute_dtype
        self.drop_rate = drop_rate
        cfg = dict(cfg)
        stem = cfg["STEM_WIDTH"]
        self.conv1 = conv2d(in_chans, stem, 3, stride=2, padding=1, compute_dtype=dt)
        self.bn1 = batch_norm(stem, compute_dtype=dt)
        self.conv2 = conv2d(stem, 64, 3, stride=2, padding=1, compute_dtype=dt)
        self.bn2 = batch_norm(64, compute_dtype=dt)

        s1 = dict(cfg["STAGE1"])
        self.layer1 = _block_layer(64, s1["BLOCK"], s1["NUM_CHANNELS"][0], s1["NUM_BLOCKS"][0],
                                   dt)
        exp1 = 4 if s1["BLOCK"] == "BOTTLENECK" else 1
        pre = [s1["NUM_CHANNELS"][0] * exp1]
        for stage_idx in (2, 3, 4):
            sc = dict(cfg[f"STAGE{stage_idx}"])
            expansion = 4 if sc["BLOCK"] == "BOTTLENECK" else 1
            cur = [c * expansion for c in sc["NUM_CHANNELS"]]
            trans = nn.ModuleList()
            for i in range(len(cur)):
                if i < len(pre):
                    trans.append(nn.Sequential(
                        conv2d(pre[i], cur[i], 3, padding=1, compute_dtype=dt),
                        batch_norm(cur[i], compute_dtype=dt), _Relu())
                        if cur[i] != pre[i] else nn.Identity())
                else:
                    chain = []
                    for j in range(i + 1 - len(pre)):
                        chs = cur[i] if j == i - len(pre) else pre[-1]
                        chain.append(nn.Sequential(
                            conv2d(pre[-1], chs, 3, stride=2, padding=1, compute_dtype=dt),
                            batch_norm(chs, compute_dtype=dt), _Relu()))
                    trans.append(nn.Sequential(*chain))
            self.add_module(f"transition{stage_idx - 1}", trans)
            self.add_module(f"stage{stage_idx}", nn.Sequential(*(
                _HRModule(sc["NUM_BRANCHES"], sc["BLOCK"], sc["NUM_BLOCKS"], cur,
                          sc["NUM_CHANNELS"], dt) for _ in range(sc["NUM_MODULES"]))))
            pre = cur

        head_channels = [32, 64, 128, 256]
        self.incre_modules = nn.ModuleList(
            _block_layer(pre[i], "BOTTLENECK", head_channels[i], 1, dt)
            for i in range(len(pre)))
        self.downsamp_modules = nn.ModuleList(nn.Sequential(
            Conv2d(head_channels[i] * 4, head_channels[i + 1] * 4, 3, stride=2, padding=1,
                   bias=True, compute_dtype=dt),
            batch_norm(head_channels[i + 1] * 4, compute_dtype=dt), _Relu())
            for i in range(len(pre) - 1))
        self.final_layer = nn.Sequential(
            Conv2d(head_channels[len(pre) - 1] * 4, 2048, 1, bias=True, compute_dtype=dt),
            batch_norm(2048, compute_dtype=dt), _Relu())
        self.num_features = 2048
        self.classifier = (Linear(2048, num_classes, compute_dtype=head_dtype(dt))
                           if num_classes > 0 else None)

    def forward(self, x: torch.Tensor, features_only: bool = False) -> torch.Tensor:
        x = act.relu(self.bn1(self.conv1(x)))
        x = act.relu(self.bn2(self.conv2(x)))
        xs = [self.layer1(x)]
        for stage_idx in (2, 3, 4):
            trans = getattr(self, f"transition{stage_idx - 1}")
            # a new branch grows from the lowest resolution so far
            xs = [t(xs[i] if i < len(xs) else xs[-1]) for i, t in enumerate(trans)]
            for module in getattr(self, f"stage{stage_idx}"):
                xs = module(xs)
        y = self.incre_modules[0](xs[0])
        for i, down in enumerate(self.downsamp_modules):
            y = self.incre_modules[i + 1](xs[i + 1]) + down(y)
        y = self.final_layer(y)
        return y if features_only else self.forward_head(y)

    def forward_head(self, x: torch.Tensor) -> torch.Tensor:
        """The class scores of a ``features_only`` map."""
        return self.classifier(head_dropout(global_avg_pool(x), self.drop_rate, self.training))


def _stage(modules, branches, block, blocks, channels):
    return (
        ("NUM_MODULES", modules), ("NUM_BRANCHES", branches), ("BLOCK", block),
        ("NUM_BLOCKS", blocks), ("NUM_CHANNELS", channels), ("FUSE_METHOD", "SUM"),
    )


def _wn_cfg(n, stem=64, s1_blocks=4, s1_ch=64, blocks=4, modules=(1, 4, 3)):
    return (
        ("STEM_WIDTH", stem),
        ("STAGE1", _stage(1, 1, "BOTTLENECK", (s1_blocks,), (s1_ch,))),
        ("STAGE2", _stage(modules[0], 2, "BASIC", (blocks,) * 2, (n, 2 * n))),
        ("STAGE3", _stage(modules[1], 3, "BASIC", (blocks,) * 3, (n, 2 * n, 4 * n))),
        ("STAGE4", _stage(modules[2], 4, "BASIC", (blocks,) * 4, (n, 2 * n, 4 * n, 8 * n))),
    )


_HRNET_CFGS: Dict[str, tuple] = {
    "hrnet_w18_small": (
        ("STEM_WIDTH", 64),
        ("STAGE1", _stage(1, 1, "BOTTLENECK", (1,), (32,))),
        ("STAGE2", _stage(1, 2, "BASIC", (2, 2), (16, 32))),
        ("STAGE3", _stage(1, 3, "BASIC", (2, 2, 2), (16, 32, 64))),
        ("STAGE4", _stage(1, 4, "BASIC", (2, 2, 2, 2), (16, 32, 64, 128))),
    ),
    "hrnet_w18_small_v2": (
        ("STEM_WIDTH", 64),
        ("STAGE1", _stage(1, 1, "BOTTLENECK", (2,), (64,))),
        ("STAGE2", _stage(1, 2, "BASIC", (2, 2), (18, 36))),
        ("STAGE3", _stage(3, 3, "BASIC", (2, 2, 2), (18, 36, 72))),
        ("STAGE4", _stage(2, 4, "BASIC", (2, 2, 2, 2), (18, 36, 72, 144))),
    ),
    "hrnet_w18": _wn_cfg(18),
    "hrnet_w30": _wn_cfg(30),
    "hrnet_w32": _wn_cfg(32),
    "hrnet_w40": _wn_cfg(40),
    "hrnet_w44": _wn_cfg(44),
    "hrnet_w48": _wn_cfg(48),
    "hrnet_w64": _wn_cfg(64),
}


def _make_entry(name, cfg):
    def entry(num_classes=1000, in_chans=3, **kw):
        return HighResolutionNet(cfg=cfg, num_classes=num_classes, in_chans=in_chans, **kw)

    entry.__name__ = name
    return register_model(entry)


for _name, _cfg in _HRNET_CFGS.items():
    _make_entry(_name, _cfg)
