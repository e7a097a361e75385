"""Hybrid int8 post-training quantisation for serving (counterpart of
``scouter_tpu/serve/quant.py``).

Only pointwise convs (kernel 1, groups 1) built by ``models.layers.conv2d``
(the backbone's; JAX's ``conv2d``) run in int8; the spatial and grouped
convs, the stem, BatchNorm, the slot head and the classifier stay in the
float compute dtype. Activations get a per-tensor dynamic symmetric absmax
scale, weights a per-output-channel symmetric one; the product is s8 x s8 ->
s32, rescaled to the input's dtype, and the bias is added after, in that
dtype, as flax's ``nn.Conv`` adds it.

On the card the product is a (B*H*W, Ci) x (Ci, Co) ``torch._int_mm``
(cuBLASLt's int8 GEMM). JAX computes the same product in ``lax.conv``
outside any Pallas kernel, so there is no TPU kernel to port here.
``_int_mm`` on CUDA wants more than 16 rows and inner and output sizes that
are multiples of 8: the operands are padded with zeros to that, which leaves
the product unchanged. A conv the policy does not cover never reaches int8,
and ``int8_conv2d`` raises for one rather than computing it in float.

Weights are quantised once, when the policy is installed on the built model
(``Int8PointwiseConv``), as XLA constant-folds the closed-over weights in the
JAX package. The JAX package's verdict on its TPU (quant.py:21-31) is not
carried over: int8 serving is measured on the card by ``chip_smoke.py``.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch
from torch import nn

__all__ = ["Int8PointwiseConv", "QUANT_POLICIES", "int8_conv2d", "quantize_weight",
           "quantized_convs"]


def _pointwise_only(weight: torch.Tensor, stride, padding, dilation, groups) -> int:
    """The stride of a pointwise conv (kernel 1, groups 1, no padding), or raise."""
    kh, kw = weight.shape[2:]
    pad = padding if isinstance(padding, (tuple, list)) else (padding, padding)
    strides = stride if isinstance(stride, (tuple, list)) else (stride, stride)
    if (kh, kw) != (1, 1) or groups != 1 or any(pad) or strides[0] != strides[1]:
        raise ValueError(
            f"int8_conv2d covers pointwise convs only (kernel 1, groups 1, no padding, one "
            f"stride); got kernel {(kh, kw)}, groups {groups}, padding {padding}, "
            f"stride {stride}")
    del dilation  # a 1x1 kernel has no taps to dilate
    return int(strides[0])


def quantize_weight(weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Co, Ci, 1, 1) weights -> (Ci, Co) int8 and the per-output-channel
    scale (Co,) f32: symmetric absmax over each output channel."""
    w = weight.to(torch.float32)
    w_max = torch.clamp_min(w.abs().amax(dim=(1, 2, 3)), 1e-6)
    w_scale = w_max / 127.0
    qw = torch.clamp(torch.round(w / w_scale[:, None, None, None]), -127, 127)
    return qw[:, :, 0, 0].t().contiguous().to(torch.int8), w_scale


def _int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) x (K, N) int8 -> int32 by ``torch._int_mm``; on CUDA the
    operands are zero-padded to M > 16 and K, N multiples of 8 first."""
    m, k = a.shape
    n = b.shape[1]
    if a.is_cuda:
        mp, kp, np_ = max(m, 17), -(-k // 8) * 8, -(-n // 8) * 8
        if (mp, kp) != (m, k):
            a = torch.nn.functional.pad(a, (0, kp - k, 0, mp - m))
        if (kp, np_) != (k, n):
            b = torch.nn.functional.pad(b, (0, np_ - n, 0, kp - k))
        return torch._int_mm(a, b)[:m, :n]
    return torch._int_mm(a, b)


def _int8_pointwise(x: torch.Tensor, qw: torch.Tensor, w_scale: torch.Tensor,
                    bias: Optional[torch.Tensor], stride: int) -> torch.Tensor:
    """The int8 pointwise conv of NCHW ``x`` with pre-quantised weights."""
    orig = x.dtype
    if stride > 1:
        x = x[:, :, ::stride, ::stride]
    b, ci, h, w = x.shape
    a = x.to(torch.float32)
    a_max = torch.clamp_min(a.abs().amax(), 1e-6)
    a_scale = a_max / 127.0
    qa = torch.clamp(torch.round(a / a_scale), -127, 127).to(torch.int8)
    rows = qa.permute(0, 2, 3, 1).reshape(b * h * w, ci)
    out = _int_mm(rows, qw).to(torch.float32) * (a_scale * w_scale)
    out = out.to(orig).reshape(b, h, w, -1).permute(0, 3, 1, 2).contiguous()
    return out if bias is None else out + bias.to(orig)[None, :, None, None]


def int8_conv2d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                stride=1, padding=0, dilation=1, groups: int = 1) -> torch.Tensor:
    """``F.conv2d`` for a pointwise conv with the product in int8 (s8 x s8 ->
    s32), rescaled to ``x.dtype`` (the counterpart of
    ``int8_conv_general_dilated``): the activations quantised per tensor, the
    weights (OIHW) per output channel, both on each call. Raises
    ``ValueError`` for any other conv."""
    s = _pointwise_only(weight, stride, padding, dilation, groups)
    qw, w_scale = quantize_weight(weight.to(x.dtype))
    return _int8_pointwise(x, qw, w_scale, bias, s)


class Int8PointwiseConv:
    """What replaces a pointwise ``layers.Conv2d`` under the int8 policy: its
    weights, cast to the conv's compute dtype, are quantised once here, and a
    call is ``int8_conv2d`` on them."""

    def __init__(self, conv: nn.Conv2d):
        self.stride = _pointwise_only(conv.weight, conv.stride, conv.padding, conv.dilation,
                                      conv.groups)
        dt = getattr(conv, "compute_dtype", None) or conv.weight.dtype
        with torch.no_grad():
            self.qw, self.w_scale = quantize_weight(conv.weight.to(dt))
        self.bias = conv.bias

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return _int8_pointwise(x, self.qw, self.w_scale, self.bias, self.stride)


def _policy_int8_pointwise(kernel_size: int, groups: int):
    """int8 for the pointwise convs only, as the JAX package's policy."""
    if kernel_size == 1 and groups == 1:
        return Int8PointwiseConv
    return None


QUANT_POLICIES = {"int8": _policy_int8_pointwise}


def policy_of(name: str):
    """The policy of ``QUANT_POLICIES`` named ``name``, or ``ValueError``."""
    if name not in QUANT_POLICIES:
        raise ValueError(f"unknown quantization policy {name!r}; known: {sorted(QUANT_POLICIES)}")
    return QUANT_POLICIES[name]


@contextlib.contextmanager
def quantized_convs(policy: str, model: nn.Module):
    """Run ``model``'s convs under the named policy inside the block (their
    weights quantised on entry), and put the float convs back after it.
    Yields the number of convs substituted. The policy lives on the model,
    not in a thread: any thread that calls it inside the block runs int8."""
    from ..models.layers import set_conv_policy

    count = set_conv_policy(model, policy_of(policy))
    try:
        yield count
    finally:
        set_conv_policy(model, None)
