"""Excitation backprop and its contrastive variant (counterpart of
``scouter_tpu/explain/excitation.py``; the capability of
``torchray/attribution/excitation_backprop.py``).

The EBP rule for a linear layer f (conv, dense, average pool), from the
reference (:60-105, :254-354):

    p' = x * f*(x, w+, p / (f(x, w+) + 1e-20))

the layer run again with its weights clamped positive and no bias, the
incoming relevance normalised by that output and propagated back, times the
input. Normalisation layers pass relevance through unchanged (:412-459);
element-wise sums split it in proportion to each addend (:459-502, the
ResNet skips). Saliency is the channel sum of the relevance (:579-600); the
contrastive variant subtracts the relevance made with the negated
classifier at a contrast layer and clamps at zero (:603-624, :647-760).

JAX patches ``jax.lax.conv_general_dilated``, ``jax.lax.dot_general`` and
flax's ``BatchNorm.__call__`` for the length of a trace. Here
:func:`ebp_rules` installs the rules in ``models.act``'s hooks, which every
conv and dense product of the backbones (``layers.Conv2d``, ``Conv1d``,
``Linear``, the blur and space-to-depth stem convs) and every
``BatchNorm2d`` ask: the same ops JAX's patch reaches, and no global patch
of ``torch.nn.functional``.
"""

from __future__ import annotations

import contextlib

import torch

from ..models import act

__all__ = ["ebp_rules", "excitation_backprop", "contrastive_excitation_backprop"]


class _EbpLinear(torch.autograd.Function):
    """One linear-layer call ``op(x, w)`` with the EBP backward; no gradient
    reaches the weight."""

    @staticmethod
    def forward(ctx, op, x, w):
        ctx.op = op
        ctx.save_for_backward(x, w)
        return op(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        w_pos = w.clamp_min(0.0)
        with torch.enable_grad():
            xd = x.detach().requires_grad_(True)
            out_pos = ctx.op(xd, w_pos)
            (gl,) = torch.autograd.grad(out_pos, xd, g / (out_pos.detach() + 1e-20))
        return None, gl * x, None


def _ebp_linear(op, x, w):
    return _EbpLinear.apply(op, x, w)


class _StraightThrough(torch.autograd.Function):
    """Value ``y``, gradient passed to ``x`` unchanged."""

    @staticmethod
    def forward(ctx, x, y):
        ctx.x_dtype = x.dtype
        return y.clone()

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.x_dtype), None


def _straight_through(x, y):
    return _StraightThrough.apply(x, y.detach())


class _EbpAdd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return a + b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        total = a + b
        return a / total * g, b / total * g


def _ebp_add(a, b):
    return _EbpAdd.apply(a, b)


class _EbpMean(torch.autograd.Function):
    """EBP-rule global average pooling (all-positive weights) over (2, 3)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x.mean(dim=(2, 3))

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        out = x.mean(dim=(2, 3))
        ghat = g / (out + 1e-20)
        hw = x.shape[2] * x.shape[3]
        return (ghat[:, :, None, None] / hw).expand_as(x) * x


def ebp_mean(x):
    return _EbpMean.apply(x)


@contextlib.contextmanager
def ebp_rules():
    """The EBP backward rules, for the length of the context."""
    with act.override_linear(_ebp_linear), act.override_norm(_straight_through), \
            act.override_residual_add(_ebp_add):
        yield


def _head_from(model, saliency_layer, class_sign=1.0):
    from .cam import fc_params

    kernel, bias = fc_params(model)

    def rest(feats):
        f = model(feats, start_from=saliency_layer, features_only=True)
        pooled = ebp_mean(f)
        # the classifier product through act.linear, so the EBP rule
        # reaches it, as JAX's explicit dot_general
        w = class_sign * kernel
        dt = torch.promote_types(pooled.dtype, w.dtype)
        out = act.linear(lambda p, k, b: p @ k, pooled.to(dt), w.to(dt))
        return out + bias.to(dt)

    return rest


def _grad(fn, x):
    with torch.enable_grad():
        xi = x.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(fn(xi), xi)
    return g


def excitation_backprop(model, x, class_idx: int, saliency_layer: str = "layer3") -> torch.Tensor:
    """EBP saliency at a stage boundary: the (h, w) channel-summed relevance."""
    with torch.no_grad():
        feats = model(x, stop_after=saliency_layer)
    rest = _head_from(model, saliency_layer)
    with ebp_rules():
        g = _grad(lambda f: rest(f)[0, class_idx], feats)
    return g[0].sum(dim=0)


def contrastive_excitation_backprop(model, x, class_idx: int, saliency_layer: str = "layer2",
                                    contrast_layer: str = "layer4") -> torch.Tensor:
    """Contrastive EBP (:647-760): the relevance at the contrast layer made
    with the w and -w classifier, subtracted, then propagated to the
    saliency layer; the channel sum is clamped at zero."""
    with torch.no_grad():
        feats_s = model(x, stop_after=saliency_layer)
        feats_c = model(feats_s, start_from=saliency_layer, stop_after=contrast_layer)
    rest_pos = _head_from(model, contrast_layer, 1.0)
    rest_neg = _head_from(model, contrast_layer, -1.0)
    with ebp_rules():
        g_pos = _grad(lambda f: rest_pos(f)[0, class_idx], feats_c)
        g_neg = _grad(lambda f: rest_neg(f)[0, class_idx], feats_c)
        contrast = (g_pos - g_neg).detach()
        g = _grad(lambda f: (model(f, start_from=saliency_layer, stop_after=contrast_layer)
                             * contrast).sum(), feats_s)
    return g[0].sum(dim=0).clamp_min(0.0)
