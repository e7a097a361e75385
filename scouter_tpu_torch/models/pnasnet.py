"""PNASNet-5 Large in NCHW (counterpart of ``scouter_tpu/models/pnasnet.py``,
after ``timm/models/pnasnet.py:38-400``).

Progressive-NAS cells: five comb-iters of paired {separable-conv stack,
max pool, relu-conv-bn} branches whose sums are concatenated (:156-184);
the stem cell and twelve cells with reduction, zero-pad and factorized
reduction variants wired in the searched topology (:296-345). Every
BatchNorm has eps 1e-3. The shifted zero-pad trick (:40-52, :92-97): pad
a zero row and column at the top and left, run the op with its own
padding (-inf for the max pool), drop the first row and column. The head
dropout defaults to 0.5 (:287). Module names are timm's (``conv_0.conv``,
``cell_stem_0.comb_iter_0_left.separable_1.depthwise_conv2d``,
``cell_0.conv_prev_1x1.path_1.conv``, ``last_linear``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from . import act
from .layers import Linear, batch_norm, conv2d, head_dropout, head_dtype
from .registry import register_model

__all__ = ["PNASNet5Large"]


def _bn(chs: int, compute_dtype=None):
    return batch_norm(chs, eps=1e-3, compute_dtype=compute_dtype)


def _shifted(fn, x: torch.Tensor) -> torch.Tensor:
    """The shifted zero-pad trick: ``fn`` on ``x`` with a zero row and column
    padded at the top and left, its first output row and column dropped."""
    return fn(F.pad(x, (1, 0, 1, 0)))[:, :, 1:, 1:]


def _maxpool(x: torch.Tensor, stride: int, zero_pad: bool) -> torch.Tensor:
    """MaxPool2d(3, stride, padding=1), with the shifted zero pad."""
    pool = lambda v: F.max_pool2d(v, 3, stride, 1)  # noqa: E731
    return _shifted(pool, x) if zero_pad else pool(x)


class _SepConv(nn.Module):
    def __init__(self, in_chs: int, out_chs: int, kernel_size: int, stride: int,
                 compute_dtype=None):
        super().__init__()
        self.depthwise_conv2d = conv2d(in_chs, in_chs, kernel_size, stride=stride,
                                       padding=kernel_size // 2, groups=in_chs,
                                       compute_dtype=compute_dtype)
        self.pointwise_conv2d = conv2d(in_chs, out_chs, 1, padding=0,
                                       compute_dtype=compute_dtype)

    def forward(self, x):
        return self.pointwise_conv2d(self.depthwise_conv2d(x))


class _BranchSeparables(nn.Module):
    def __init__(self, in_chs: int, out_chs: int, kernel_size: int, stride: int = 1,
                 stem_cell: bool = False, zero_pad: bool = False, compute_dtype=None):
        super().__init__()
        dt = compute_dtype
        middle = out_chs if stem_cell else in_chs
        self.zero_pad = zero_pad
        self.separable_1 = _SepConv(in_chs, middle, kernel_size, stride, dt)
        self.bn_sep_1 = _bn(middle, dt)
        self.separable_2 = _SepConv(middle, out_chs, kernel_size, 1, dt)
        self.bn_sep_2 = _bn(out_chs, dt)

    def forward(self, x):
        x = act.relu(x)
        x = _shifted(self.separable_1, x) if self.zero_pad else self.separable_1(x)
        x = self.separable_2(act.relu(self.bn_sep_1(x)))
        return self.bn_sep_2(x)


class _ReluConvBn(nn.Module):
    def __init__(self, in_chs: int, out_chs: int, kernel_size: int = 1, stride: int = 1,
                 compute_dtype=None):
        super().__init__()
        self.conv = conv2d(in_chs, out_chs, kernel_size, stride=stride, padding=0,
                           compute_dtype=compute_dtype)
        self.bn = _bn(out_chs, compute_dtype)

    def forward(self, x):
        return self.bn(self.conv(act.relu(x)))


class _ReductionPath(nn.Module):
    """A 1x1 conv on every second row and column (timm's AvgPool2d(1, 2) and
    conv)."""

    def __init__(self, in_chs: int, out_chs: int, compute_dtype=None):
        super().__init__()
        self.conv = conv2d(in_chs, out_chs, 1, padding=0, compute_dtype=compute_dtype)

    def forward(self, x):
        return self.conv(x[:, :, ::2, ::2])


def _two_paths(path_1: nn.Module, path_2: nn.Module, x_relu: torch.Tensor) -> torch.Tensor:
    """The factorized reduction's two paths, the second on the input shifted
    by one row and column (zero-padded at the bottom and right)."""
    shifted_x = F.pad(x_relu, (0, 1, 0, 1))[:, :, 1:, 1:]
    return torch.cat([path_1(x_relu), path_2(shifted_x)], dim=1)


class _FactorizedReduction(nn.Module):
    def __init__(self, in_chs: int, out_chs: int, compute_dtype=None):
        super().__init__()
        dt = compute_dtype
        self.path_1 = _ReductionPath(in_chs, out_chs // 2, dt)
        self.path_2 = _ReductionPath(in_chs, out_chs // 2, dt)
        self.final_path_bn = _bn(out_chs // 2 * 2, dt)

    def forward(self, x):
        return self.final_path_bn(_two_paths(self.path_1, self.path_2, act.relu(x)))


class _MaxPoolConvBn(nn.Module):
    """The stem cell's comb_iter_0_right: max pool -> 1x1 conv -> bn (:197-202)."""

    def __init__(self, in_chs: int, out_chs: int, compute_dtype=None):
        super().__init__()
        self.conv = conv2d(in_chs, out_chs, 1, padding=0, compute_dtype=compute_dtype)
        self.bn = _bn(out_chs, compute_dtype)

    def forward(self, x):
        return self.bn(self.conv(_maxpool(x, 2, False)))


class _CellStem0(nn.Module):
    def __init__(self, in_chs: int, out_left: int, out_right: int, compute_dtype=None):
        super().__init__()
        dt, r = compute_dtype, out_right
        self.conv_1x1 = _ReluConvBn(in_chs, r, 1, compute_dtype=dt)
        self.comb_iter_0_left = _BranchSeparables(in_chs, out_left, 5, 2, stem_cell=True,
                                                  compute_dtype=dt)
        self.comb_iter_0_right = _MaxPoolConvBn(in_chs, out_left, dt)
        self.comb_iter_1_left = _BranchSeparables(r, r, 7, 2, compute_dtype=dt)
        self.comb_iter_2_left = _BranchSeparables(r, r, 5, 2, compute_dtype=dt)
        self.comb_iter_2_right = _BranchSeparables(r, r, 3, 2, compute_dtype=dt)
        self.comb_iter_3_left = _BranchSeparables(r, r, 3, 1, compute_dtype=dt)
        self.comb_iter_4_left = _BranchSeparables(in_chs, r, 3, 2, stem_cell=True,
                                                  compute_dtype=dt)
        self.comb_iter_4_right = _ReluConvBn(r, r, 1, 2, compute_dtype=dt)
        self.out_chs = out_left + 4 * r

    def forward(self, x_left):
        x_right = self.conv_1x1(x_left)
        c0 = self.comb_iter_0_left(x_left) + self.comb_iter_0_right(x_left)
        c1 = self.comb_iter_1_left(x_right) + _maxpool(x_right, 2, False)
        c2 = self.comb_iter_2_left(x_right) + self.comb_iter_2_right(x_right)
        c3 = self.comb_iter_3_left(c2) + _maxpool(x_right, 2, False)
        c4 = self.comb_iter_4_left(x_left) + self.comb_iter_4_right(x_right)
        return torch.cat([c0, c1, c2, c3, c4], dim=1)


class _PCell(nn.Module):
    def __init__(self, in_left: int, in_right: int, out_left: int, out_right: int,
                 is_reduction: bool = False, zero_pad: bool = False, match_prev: bool = False,
                 compute_dtype=None):
        super().__init__()
        dt, l, r = compute_dtype, out_left, out_right
        s = 2 if is_reduction else 1
        self.stride, self.zero_pad = s, zero_pad
        self.conv_prev_1x1 = (_FactorizedReduction(in_left, l, dt) if match_prev
                              else _ReluConvBn(in_left, l, 1, compute_dtype=dt))
        self.conv_1x1 = _ReluConvBn(in_right, r, 1, compute_dtype=dt)
        zp = zero_pad
        self.comb_iter_0_left = _BranchSeparables(l, l, 5, s, zero_pad=zp, compute_dtype=dt)
        self.comb_iter_1_left = _BranchSeparables(r, r, 7, s, zero_pad=zp, compute_dtype=dt)
        self.comb_iter_2_left = _BranchSeparables(r, r, 5, s, zero_pad=zp, compute_dtype=dt)
        self.comb_iter_2_right = _BranchSeparables(r, r, 3, s, zero_pad=zp, compute_dtype=dt)
        self.comb_iter_3_left = _BranchSeparables(r, r, 3, 1, compute_dtype=dt)
        self.comb_iter_4_left = _BranchSeparables(l, l, 3, s, zero_pad=zp, compute_dtype=dt)
        self.comb_iter_4_right = (_ReluConvBn(r, r, 1, s, compute_dtype=dt) if is_reduction
                                  else None)
        self.out_chs = 2 * l + 3 * r

    def forward(self, x_left, x_right):
        s, zp = self.stride, self.zero_pad
        x_left = self.conv_prev_1x1(x_left)
        x_right = self.conv_1x1(x_right)
        c0 = self.comb_iter_0_left(x_left) + _maxpool(x_left, s, zp)
        c1 = self.comb_iter_1_left(x_right) + _maxpool(x_right, s, zp)
        c2 = self.comb_iter_2_left(x_right) + self.comb_iter_2_right(x_right)
        c3 = self.comb_iter_3_left(c2) + _maxpool(x_right, s, zp)
        c4_right = x_right if self.comb_iter_4_right is None else self.comb_iter_4_right(x_right)
        c4 = self.comb_iter_4_left(x_left) + c4_right
        return torch.cat([c0, c1, c2, c3, c4], dim=1)


class _Conv0(nn.Module):
    def __init__(self, in_chans: int, compute_dtype=None):
        super().__init__()
        self.conv = conv2d(in_chans, 96, 3, stride=2, padding=0, compute_dtype=compute_dtype)
        self.bn = _bn(96, compute_dtype)

    def forward(self, x):
        return self.bn(self.conv(x))


class PNASNet5Large(nn.Module):
    """PNASNet-5 Large (``timm/models/pnasnet.py:279-400``). ``num_classes=0``
    builds no ``last_linear``; ``features_only`` returns the last cell's
    map after a ReLU."""

    def __init__(self, num_classes: int = 1000, in_chans: int = 3, drop_rate: float = 0.5,
                 mnist_stem: bool = False, compute_dtype=None):
        super().__init__()
        del mnist_stem  # the JAX family takes and ignores it
        dt = compute_dtype
        self.drop_rate = drop_rate
        self.conv_0 = _Conv0(in_chans, dt)
        self.cell_stem_0 = _CellStem0(96, 54, 54, dt)
        self.cell_stem_1 = _PCell(96, self.cell_stem_0.out_chs, 108, 108, is_reduction=True,
                                  match_prev=True, compute_dtype=dt)
        specs = [
            dict(out=216, match_prev=True), dict(out=216), dict(out=216), dict(out=216),
            dict(out=432, is_reduction=True, zero_pad=True),
            dict(out=432, match_prev=True), dict(out=432), dict(out=432),
            dict(out=864, is_reduction=True),
            dict(out=864, match_prev=True), dict(out=864), dict(out=864),
        ]
        prev, cur = self.cell_stem_0.out_chs, self.cell_stem_1.out_chs
        for i, spec in enumerate(specs):
            out = spec.pop("out")
            cell = _PCell(prev, cur, out, out, compute_dtype=dt, **spec)
            self.add_module(f"cell_{i}", cell)
            prev, cur = cur, cell.out_chs
        self.num_cells = len(specs)
        self.num_features = cur
        self.last_linear = (Linear(cur, num_classes, compute_dtype=head_dtype(dt))
                            if num_classes > 0 else None)

    def forward(self, x: torch.Tensor, features_only: bool = False) -> torch.Tensor:
        x_conv_0 = self.conv_0(x)
        x_stem_0 = self.cell_stem_0(x_conv_0)
        prev, cur = x_stem_0, self.cell_stem_1(x_conv_0, x_stem_0)
        for i in range(self.num_cells):
            prev, cur = cur, getattr(self, f"cell_{i}")(prev, cur)
        x = act.relu(cur)
        return x if features_only else self.forward_head(x)

    def forward_head(self, x: torch.Tensor) -> torch.Tensor:
        """The class scores of a ``features_only`` map."""
        return self.last_linear(head_dropout(x.mean(dim=(2, 3)), self.drop_rate, self.training))


@register_model
def pnasnet5large(num_classes=1000, in_chans=3, **kw):
    return PNASNet5Large(num_classes=num_classes, in_chans=in_chans, **kw)
