"""Auxiliary losses (counterpart of ``scouter_tpu/ops/extra_losses.py``,
timm's ``timm/loss/``): label-smoothing CE, soft-target CE and AugMix's
Jensen-Shannon CE.

Logits are upcast to float32 first, so bf16 class scores reduce in f32, as
``ops/losses.py`` does. Each log of a probability is taken after a clip to
[1e-7, 1], as in the JAX package.
"""

from __future__ import annotations

import torch

__all__ = ["jsd_cross_entropy", "label_smoothing_cross_entropy", "soft_target_cross_entropy"]


def _log_softmax(logits: torch.Tensor) -> torch.Tensor:
    return torch.log_softmax(logits.to(torch.float32), dim=-1)


def label_smoothing_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                  smoothing: float = 0.1) -> torch.Tensor:
    """LabelSmoothingCrossEntropy: (1-eps)*nll + eps*mean(-logprobs)."""
    logp = _log_softmax(logits)
    nll = -logp.gather(1, labels.long()[:, None])[:, 0]
    smooth = -logp.mean(dim=-1)
    return ((1.0 - smoothing) * nll + smoothing * smooth).mean()


def soft_target_cross_entropy(logits: torch.Tensor, target_probs: torch.Tensor) -> torch.Tensor:
    """SoftTargetCrossEntropy: -sum(target * logprobs) averaged over the batch."""
    return (-(target_probs * _log_softmax(logits)).sum(dim=-1)).mean()


def jsd_cross_entropy(logits_clean: torch.Tensor, logits_aug1: torch.Tensor,
                      logits_aug2: torch.Tensor, labels: torch.Tensor,
                      alpha: float = 12.0, smoothing: float = 0.1) -> torch.Tensor:
    """JsdCrossEntropy (AugMix): smoothed CE on the clean logits + alpha *
    the mean KL of each branch to the mixture distribution."""
    ce = label_smoothing_cross_entropy(logits_clean, labels, smoothing)
    ps = [torch.softmax(l.to(torch.float32), dim=-1)
          for l in (logits_clean, logits_aug1, logits_aug2)]
    log_mix = torch.log(torch.clamp(sum(ps) / 3.0, 1e-7, 1.0))
    kl = sum((p * (torch.log(torch.clamp(p, 1e-7, 1.0)) - log_mix)).sum(dim=-1).mean()
             for p in ps) / 3.0
    return ce + alpha * kl
