"""CAM-family attribution (counterpart of ``scouter_tpu/explain/cam.py``; the
capabilities of the vendored torchcam, ``torchcam/cams/cam.py:15-447``,
``gradcam.py:15-274``).

No hooks: the backbone's features/head split is explicit (``features_only``
and the pooling head replicated), activations come from the features
forward and their gradients from ``torch.autograd.grad`` over the head, and
the masked-forward families (Score-CAM etc.) run their channel sweeps in
chunks of ``batch_size``.

Every extractor takes one NCHW image (1, C, H, W) on the model's device and
returns an (h, w) map, min-max normalised by default (``cam.py:50-56``).
The random methods draw their noise from a ``torch.Generator`` on the CPU
(``seed``), so the card and the CPU see the same samples; JAX draws from
keys inside its program, and a pre-drawn ``noise`` takes the place of
either.
"""

from __future__ import annotations

from typing import Optional

import torch

from ._resize import resize_bilinear

__all__ = [
    "backbone_split",
    "fc_params",
    "cam",
    "gradcam",
    "gradcampp",
    "smooth_gradcampp",
    "scorecam",
    "sscam",
    "isscam",
]


def fc_params(model):
    """(kernel (K, classes), bias) of the classifier head, in JAX's layout:
    ``model.fc`` of the zoo's ResNet and of the caffe benchmark models."""
    return model.fc.weight.t(), model.fc.bias


def backbone_split(model):
    """(features, head, forward) closures for a zoo backbone in eval mode.

    ``head`` replicates the ResNet pooling head (global average pool + fc),
    so gradients with respect to the last conv features are direct. As in
    JAX, a bf16 feature map meets the f32 classifier in f32."""

    def features(x):
        return model(x, features_only=True)  # (B, K, h, w)

    kernel, bias = fc_params(model)

    def head(feats):
        pooled = feats.mean(dim=(2, 3))
        dt = torch.promote_types(pooled.dtype, kernel.dtype)
        return pooled.to(dt) @ kernel.to(dt) + bias.to(dt)

    def forward(x):
        return head(features(x))

    return features, head, forward


def _normalize(m: torch.Tensor) -> torch.Tensor:
    """Per-map min-max over the spatial dims (torchcam _normalize)."""
    lo = m.amin(dim=(-2, -1), keepdim=True)
    hi = m.amax(dim=(-2, -1), keepdim=True)
    return (m - lo) / (hi - lo)


def _combine(feats: torch.Tensor, weights: torch.Tensor, relu: bool, normalized: bool):
    """Weighted channel sum -> (h, w). feats: (1, K, h, w), weights: (K,)."""
    a = feats[0] * weights[:, None, None]
    a = torch.where(torch.isnan(a), torch.ones((), dtype=a.dtype, device=a.device), a)
    m = a.sum(dim=0)  # the torchcam nan -> 1 quirk (cam.py:105-107) above
    if relu:
        m = torch.relu(m)
    return _normalize(m) if normalized else m


def cam(model, x, class_idx: int, normalized: bool = True):
    """Plain CAM: fc weights of the target class (cam.py:121-164)."""
    features, _, _ = backbone_split(model)
    with torch.no_grad():
        feats = features(x)
    weights = fc_params(model)[0][:, class_idx].detach()
    return _combine(feats, weights, relu=False, normalized=normalized)


def _head_grad(head, feats: torch.Tensor, class_idx: int) -> torch.Tensor:
    with torch.enable_grad():
        f = feats.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(head(f)[0, class_idx], f)
    return g


def _feat_grad(model, x, class_idx: int):
    features, head, _ = backbone_split(model)
    with torch.no_grad():
        feats = features(x)
    return feats, _head_grad(head, feats, class_idx)


def gradcam(model, x, class_idx: int, normalized: bool = True):
    """Grad-CAM: spatial-mean gradient weights (gradcam.py:93-119)."""
    feats, g = _feat_grad(model, x, class_idx)
    weights = g[0].mean(dim=(1, 2))  # (K,)
    return _combine(feats, weights, relu=True, normalized=normalized)


def _pp_weights(feats, g):
    """Grad-CAM++ alpha-weighted ReLU-gradient weights (gradcam.py:150-160)."""
    g2 = g ** 2
    g3 = g ** 3
    denom = 2.0 * g2 + (g3 * feats).sum(dim=(2, 3), keepdim=True)
    alpha = g2 / denom
    return (alpha[0] * torch.relu(g[0])).sum(dim=(1, 2))  # (K,)


def gradcampp(model, x, class_idx: int, normalized: bool = True):
    feats, g = _feat_grad(model, x, class_idx)
    return _combine(feats, _pp_weights(feats, g), relu=True, normalized=normalized)


def _draw_normal(shape, scale: float, seed: int, device) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return (scale * torch.randn(shape, generator=g)).to(device)


def smooth_gradcampp(model, x, class_idx: int, seed: int = 0, num_samples: int = 4,
                     std: float = 0.3, normalized: bool = True,
                     noise: Optional[torch.Tensor] = None):
    """Smooth Grad-CAM++ (gradcam.py:162-274): gradient moments averaged
    over noisy inputs; the ReLU-gradient factor uses the last sample's
    gradient, and the map combines the last noisy sample's features
    (reference quirks, gradcam.py:268-271 and cam.py:103).

    ``noise``: (num_samples, 1, C, H, W) perturbations; drawn from ``seed``
    as ``std`` x N(0, 1) when None."""
    features, head, _ = backbone_split(model)
    if noise is None:
        noise = _draw_normal((num_samples, *x.shape), std, seed, x.device)
    noise = noise.to(x.device, x.dtype)
    with torch.no_grad():
        init_feats = features(x)
    grads = []
    for n in noise:
        with torch.no_grad():
            feats_n = features(x + n)
        grads.append(_head_grad(head, feats_n, class_idx))
    grads = torch.stack(grads)  # (n, 1, K, h, w)
    g2 = (grads ** 2).mean(dim=0)
    g3 = (grads ** 3).mean(dim=0)
    denom = 2.0 * g2 + (g3 * init_feats).sum(dim=(2, 3), keepdim=True)
    alpha = g2 / denom
    weights = (alpha[0] * torch.relu(grads[-1][0])).sum(dim=(1, 2))
    return _combine(feats_n, weights, relu=True, normalized=normalized)


def _normalize_channels(feats: torch.Tensor) -> torch.Tensor:
    """Per-channel spatial min-max of (1, K, h, w) activations (NaN where a
    channel is constant: the 0/0 the reference also produces)."""
    lo = feats.amin(dim=(2, 3), keepdim=True)
    hi = feats.amax(dim=(2, 3), keepdim=True)
    return (feats - lo) / (hi - lo)


def _channel_masks(norm_feats: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Each normalised channel upsampled to the input (cam.py:221-231):
    (K, 1, H, W) masks for the (1, C, H, W) input."""
    return resize_bilinear(norm_feats[0], tuple(x.shape[2:]))[:, None]


def _masked_scores(forward, count: int, chunk, class_idx: int, batch_size: int) -> torch.Tensor:
    """Softmax class probabilities of a stack of ``count`` masked images,
    ``chunk(start, stop)`` making them ``batch_size`` at a time."""
    out = []
    with torch.no_grad():
        for start in range(0, count, batch_size):
            images = chunk(start, min(start + batch_size, count))
            out.append(torch.softmax(forward(images), dim=1)[:, class_idx])
    return torch.cat(out)


def _score_inputs(model, x):
    features, _, forward = backbone_split(model)
    with torch.no_grad():
        norm_feats = _normalize_channels(features(x))
        masks = _channel_masks(norm_feats, x)  # (K, 1, H, W)
    return norm_feats, masks, forward


def scorecam(model, x, class_idx: int, batch_size: int = 32, normalized: bool = True):
    """Score-CAM (cam.py:166-258): masked-input softmax re-scoring.

    Reference quirk kept: ``_normalize(self.hook_a)`` mutates the hooked
    activation in place (cam.py:231), so the final weighted combination
    uses the per-channel NORMALISED maps, not the raw activations."""
    norm_feats, masks, forward = _score_inputs(model, x)
    weights = _masked_scores(forward, masks.shape[0], lambda a, b: masks[a:b] * x[0],
                             class_idx, batch_size)
    return _combine(norm_feats, weights, relu=True, normalized=normalized)


def sscam(model, x, class_idx: int, seed: int = 0, batch_size: int = 32,
          num_samples: int = 35, std: float = 2.0, normalized: bool = True,
          noise: Optional[torch.Tensor] = None):
    """SS-CAM (cam.py:260-358): noise added to the masks before they
    multiply the input. Same in-place-normalisation quirk as scorecam
    (cam.py:330-333).

    ``noise``: (num_samples, C, H, W) perturbations; drawn from ``seed`` as
    ``std`` x N(0, 1) when None."""
    norm_feats, masks, forward = _score_inputs(model, x)
    if noise is None:
        noise = _draw_normal((num_samples, *x.shape[1:]), std, seed, x.device)
    noise = noise.to(x.device, x.dtype)
    total = None
    for n in noise:
        w = _masked_scores(forward, masks.shape[0], lambda a, b, n=n: x[0] * (masks[a:b] + n),
                           class_idx, batch_size)
        total = w if total is None else total + w
    return _combine(norm_feats, total / noise.shape[0], relu=True, normalized=normalized)


def isscam(model, x, class_idx: int, batch_size: int = 32, num_samples: int = 10,
           normalized: bool = True):
    """ISS-CAM (cam.py:361-447): integration over mask intensity scaling.
    The step-m input is sum_{i<=m} i/N * (x * mask), accumulated as JAX's
    scan does; the scores of the steps add up. Same in-place-normalisation
    quirk as scorecam (cam.py:419-422)."""
    norm_feats, masks, forward = _score_inputs(model, x)
    with torch.no_grad():
        base = x[0] * masks  # (K, C, H, W)
        fmap = torch.zeros_like(base)
        weights = None
        for idx in range(num_samples):
            fmap = fmap + (idx + 1.0) / num_samples * base
            w = _masked_scores(forward, fmap.shape[0], lambda a, b: fmap[a:b], class_idx,
                               batch_size)
            weights = w if weights is None else weights + w
    return _combine(norm_feats, weights, relu=True, normalized=normalized)
