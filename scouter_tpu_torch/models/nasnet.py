"""NASNet-A Large in NCHW (counterpart of ``scouter_tpu/models/nasnet.py``,
after ``timm/models/nasnet.py:27-621``).

The searched NASNet-A cells: stem cells with asymmetric comb-iters
(:131-252), first and normal cells whose previous input takes the two-path
factorized reduction or a relu-conv-bn (:254-375), and two reduction cells,
the first with the shifted zero-pad pools and separable branches (:27-52,
:376-484), wired six cells a stage at ``num_features`` 4032 (:486-556).
Every BatchNorm has eps 1e-3; the separable branches and relu-conv-bn
units are PNASNet's (``pnasnet.py``: every padding here is k // 2, and the
shifted pad is the reduction cell's); the average pools leave their own
padding out of the count, while the zeros of the shifted pad count. Module names
are timm's (``conv0.conv``, ``cell_stem_0.comb_iter_0_right.separable_1.
depthwise_conv2d``, ``cell_0.path_2.conv``, ``reduction_cell_1.conv_1x1.bn``,
``last_linear``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from . import act
from .layers import Linear, conv2d, head_dropout, head_dtype
from .pnasnet import _BranchSeparables, _ReluConvBn, _bn, _shifted, _two_paths
from .pnasnet import _ReductionPath as _Path
from .registry import register_model

__all__ = ["NASNetALarge"]


def _avgpool_nopad(x: torch.Tensor, stride: int) -> torch.Tensor:
    """AvgPool2d(3, stride, 1, count_include_pad=False)."""
    return F.avg_pool2d(x, 3, stride, 1, count_include_pad=False)


def _maxpool(x: torch.Tensor, stride: int = 2) -> torch.Tensor:
    return F.max_pool2d(x, 3, stride, 1)


def _maxpool_pad(x: torch.Tensor) -> torch.Tensor:
    """MaxPoolPad (:27-38): shift-pad, pool, crop."""
    return _shifted(_maxpool, x)


def _avgpool_pad(x: torch.Tensor) -> torch.Tensor:
    """AvgPoolPad (:41-52): the padded zeros count, the pool's own padding not."""
    return _shifted(lambda v: _avgpool_nopad(v, 2), x)


class _CellStem0(nn.Module):
    def __init__(self, in_chs: int, c: int, compute_dtype=None):
        super().__init__()
        dt = compute_dtype
        self.conv_1x1 = _ReluConvBn(in_chs, c, compute_dtype=dt)
        self.comb_iter_0_left = _BranchSeparables(c, c, 5, 2, compute_dtype=dt)
        self.comb_iter_0_right = _BranchSeparables(in_chs, c, 7, 2, stem_cell=True,
                                                   compute_dtype=dt)
        self.comb_iter_1_right = _BranchSeparables(in_chs, c, 7, 2, stem_cell=True,
                                                   compute_dtype=dt)
        self.comb_iter_2_right = _BranchSeparables(in_chs, c, 5, 2, stem_cell=True,
                                                   compute_dtype=dt)
        self.comb_iter_4_left = _BranchSeparables(c, c, 3, 1, compute_dtype=dt)
        self.out_chs = 4 * c

    def forward(self, x):
        x1 = self.conv_1x1(x)
        c0 = self.comb_iter_0_left(x1) + self.comb_iter_0_right(x)
        c1 = _maxpool(x1, 2) + self.comb_iter_1_right(x)
        c2 = _avgpool_nopad(x1, 2) + self.comb_iter_2_right(x)
        c3 = _avgpool_nopad(c0, 1) + c1
        c4 = self.comb_iter_4_left(c0) + _maxpool(x1, 2)
        return torch.cat([c1, c2, c3, c4], dim=1)


class _CellStem1(nn.Module):
    def __init__(self, in_conv0: int, in_stem0: int, c: int, compute_dtype=None):
        super().__init__()
        dt = compute_dtype
        self.conv_1x1 = _ReluConvBn(in_stem0, c, compute_dtype=dt)
        # the factorized reduction of x_conv0 (:197-230)
        self.path_1 = _Path(in_conv0, c // 2, dt)
        self.path_2 = _Path(in_conv0, c // 2, dt)
        self.final_path_bn = _bn(c // 2 * 2, dt)
        self.comb_iter_0_left = _BranchSeparables(c, c, 5, 2, compute_dtype=dt)
        self.comb_iter_0_right = _BranchSeparables(c // 2 * 2, c, 7, 2, compute_dtype=dt)
        self.comb_iter_1_right = _BranchSeparables(c // 2 * 2, c, 7, 2, compute_dtype=dt)
        self.comb_iter_2_right = _BranchSeparables(c // 2 * 2, c, 5, 2, compute_dtype=dt)
        self.comb_iter_4_left = _BranchSeparables(c, c, 3, 1, compute_dtype=dt)
        self.out_chs = 4 * c

    def forward(self, x_conv0, x_stem_0):
        x_left = self.conv_1x1(x_stem_0)
        x_right = self.final_path_bn(_two_paths(self.path_1, self.path_2, act.relu(x_conv0)))
        c0 = self.comb_iter_0_left(x_left) + self.comb_iter_0_right(x_right)
        c1 = _maxpool(x_left, 2) + self.comb_iter_1_right(x_right)
        c2 = _avgpool_nopad(x_left, 2) + self.comb_iter_2_right(x_right)
        c3 = _avgpool_nopad(c0, 1) + c1
        c4 = self.comb_iter_4_left(c0) + _maxpool(x_left, 2)
        return torch.cat([c1, c2, c3, c4], dim=1)


class _NormalCell(nn.Module):
    """NormalCell (:320-375); ``first`` is FirstCell (:254-318): its previous
    input takes the two-path factorized reduction, ``out_left`` wide a path."""

    def __init__(self, in_x: int, in_prev: int, out_left: int, out_right: int,
                 first: bool = False, compute_dtype=None):
        super().__init__()
        dt, r = compute_dtype, out_right
        self.first = first
        if first:
            self.path_1 = _Path(in_prev, out_left, dt)
            self.path_2 = _Path(in_prev, out_left, dt)
            self.final_path_bn = _bn(2 * out_left, dt)
            lw = 2 * out_left
        else:
            self.conv_prev_1x1 = _ReluConvBn(in_prev, out_left, compute_dtype=dt)
            lw = out_left
        self.conv_1x1 = _ReluConvBn(in_x, r, compute_dtype=dt)
        l = out_left if not first else r  # the width of the branches on x_left
        self.comb_iter_0_left = _BranchSeparables(r, r, 5, 1, compute_dtype=dt)
        self.comb_iter_0_right = _BranchSeparables(lw, l, 3, 1, compute_dtype=dt)
        self.comb_iter_1_left = _BranchSeparables(lw, l, 5, 1, compute_dtype=dt)
        self.comb_iter_1_right = _BranchSeparables(lw, l, 3, 1, compute_dtype=dt)
        self.comb_iter_4_left = _BranchSeparables(r, r, 3, 1, compute_dtype=dt)
        self.out_chs = 2 * lw + l + 3 * r

    def forward(self, x, x_prev):
        if self.first:
            x_left = self.final_path_bn(_two_paths(self.path_1, self.path_2, act.relu(x_prev)))
        else:
            x_left = self.conv_prev_1x1(x_prev)
        x_right = self.conv_1x1(x)
        c0 = self.comb_iter_0_left(x_right) + self.comb_iter_0_right(x_left)
        c1 = self.comb_iter_1_left(x_left) + self.comb_iter_1_right(x_left)
        c2 = _avgpool_nopad(x_right, 1) + x_left
        c3 = _avgpool_nopad(x_left, 1) + _avgpool_nopad(x_left, 1)
        c4 = self.comb_iter_4_left(x_right) + x_right
        return torch.cat([x_left, c0, c1, c2, c3, c4], dim=1)


class _ReductionCell(nn.Module):
    """ReductionCell0 (``pad_variant``, the shifted-pad pools and branches,
    :376-429) or ReductionCell1 (:431-484)."""

    def __init__(self, in_x: int, in_prev: int, out_left: int, out_right: int,
                 pad_variant: bool, compute_dtype=None):
        super().__init__()
        dt, r, red = compute_dtype, out_right, pad_variant
        self.pad_variant = pad_variant
        self.conv_prev_1x1 = _ReluConvBn(in_prev, out_left, compute_dtype=dt)
        self.conv_1x1 = _ReluConvBn(in_x, r, compute_dtype=dt)
        self.comb_iter_0_left = _BranchSeparables(r, r, 5, 2, zero_pad=red, compute_dtype=dt)
        self.comb_iter_0_right = _BranchSeparables(out_left, r, 7, 2, zero_pad=red,
                                                   compute_dtype=dt)
        self.comb_iter_1_right = _BranchSeparables(out_left, r, 7, 2, zero_pad=red,
                                                   compute_dtype=dt)
        self.comb_iter_2_right = _BranchSeparables(out_left, r, 5, 2, zero_pad=red,
                                                   compute_dtype=dt)
        self.comb_iter_4_left = _BranchSeparables(r, r, 3, 1, zero_pad=red, compute_dtype=dt)
        self.out_chs = 4 * r

    def forward(self, x, x_prev):
        x_left = self.conv_prev_1x1(x_prev)
        x_right = self.conv_1x1(x)
        mp = _maxpool_pad if self.pad_variant else _maxpool
        ap = _avgpool_pad if self.pad_variant else (lambda v: _avgpool_nopad(v, 2))
        c0 = self.comb_iter_0_left(x_right) + self.comb_iter_0_right(x_left)
        c1 = mp(x_right) + self.comb_iter_1_right(x_left)
        c2 = ap(x_right) + self.comb_iter_2_right(x_left)
        c3 = _avgpool_nopad(c0, 1) + c1
        c4 = self.comb_iter_4_left(c0) + mp(x_right)
        return torch.cat([c1, c2, c3, c4], dim=1)


class _Conv0(nn.Module):
    def __init__(self, in_chans: int, compute_dtype=None):
        super().__init__()
        self.conv = conv2d(in_chans, 96, 3, stride=2, padding=0, compute_dtype=compute_dtype)
        self.bn = _bn(96, compute_dtype)

    def forward(self, x):
        return self.bn(self.conv(x))


class NASNetALarge(nn.Module):
    """NASNet-A Large (``timm/models/nasnet.py:486-621``). ``num_features``
    and ``channel_multiplier`` set the cells' widths (ch = num_features //
    24); ``conv0`` is 96 wide whatever ``stem_size`` says, as in the JAX
    package. ``num_classes=0`` builds no ``last_linear``; ``features_only``
    returns the last cell's map after a ReLU."""

    def __init__(self, num_classes: int = 1000, in_chans: int = 3, stem_size: int = 96,
                 num_features: int = 4032, channel_multiplier: int = 2,
                 drop_rate: float = 0.0, mnist_stem: bool = False, compute_dtype=None):
        super().__init__()
        del mnist_stem, stem_size  # the JAX family takes and ignores them
        dt = compute_dtype
        self.drop_rate = drop_rate
        ch = num_features // 24
        m = channel_multiplier
        self.conv0 = _Conv0(in_chans, dt)
        self.cell_stem_0 = _CellStem0(96, ch // (m ** 2), dt)
        self.cell_stem_1 = _CellStem1(96, self.cell_stem_0.out_chs, ch // m, dt)
        # each cell's (name, the cell its x is, the cell its prev is)
        widths = {"stem_0": self.cell_stem_0.out_chs, "stem_1": self.cell_stem_1.out_chs}
        self.wiring = []
        x, prev = "stem_1", "stem_0"

        def add(name, cell, x_in, prev_in):
            self.add_module(name, cell)
            self.wiring.append((name, x_in, prev_in))
            widths[name] = cell.out_chs

        for stage, (k, first_in) in enumerate(((1, None), (2, "reduction_cell_0"),
                                               (4, "reduction_cell_1"))):
            if first_in is not None:
                red = first_in
                add(red, _ReductionCell(widths[x], widths[prev], k * ch, k * ch, stage == 1, dt),
                    x, prev)
                x = red  # the first cell after a reduction reads the cell before it as prev
            first = f"cell_{6 * stage}"
            add(first, _NormalCell(widths[x], widths[prev], k * ch // 2, k * ch, first=True,
                                   compute_dtype=dt), x, prev)
            prev, x = x, first
            for i in range(6 * stage + 1, 6 * stage + 6):
                add(f"cell_{i}", _NormalCell(widths[x], widths[prev], k * ch, k * ch,
                                             compute_dtype=dt), x, prev)
                prev, x = x, f"cell_{i}"
        self.num_features = widths[x]
        self.last_linear = (Linear(self.num_features, num_classes,
                                   compute_dtype=head_dtype(dt)) if num_classes > 0 else None)

    def forward(self, x: torch.Tensor, features_only: bool = False) -> torch.Tensor:
        x_conv0 = self.conv0(x)
        out = {"stem_0": self.cell_stem_0(x_conv0)}
        out["stem_1"] = self.cell_stem_1(x_conv0, out["stem_0"])
        for name, x_in, prev_in in self.wiring:
            out[name] = getattr(self, name)(out[x_in], out[prev_in])
        x = act.relu(out[self.wiring[-1][0]])
        return x if features_only else self.forward_head(x)

    def forward_head(self, x: torch.Tensor) -> torch.Tensor:
        """The class scores of a ``features_only`` map."""
        return self.last_linear(head_dropout(x.mean(dim=(2, 3)), self.drop_rate, self.training))


@register_model
def nasnetalarge(num_classes=1000, in_chans=3, **kw):
    return NASNetALarge(num_classes=num_classes, in_chans=in_chans, **kw)
