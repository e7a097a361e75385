"""The serving function (counterpart of ``scouter_tpu/serve/export.py``):

    uint8 images (B, img_size, img_size, C)
      -> normalise (data/transforms.preprocess_batch; the client ships
         pre-sized images, so the resize is the identity)
      -> SlotModel forward (eval mode, running BN stats)
      -> logits (B, num_classes) float32
      -> per-class slot maps (B, num_classes, fs, fs) uint8, min-max scaled
         per sample over the whole map set

One deliberate difference from the JAX package: the model is built with
``fused_slot=True``. JAX serves the jnp slot path (``fused_slot=False``)
because XLA fuses those ops with their neighbours and a Pallas call would cut
that fusion; eager PyTorch has no such fusion, so on the card the slot head
runs through the hand-written xSlot kernel (``ops/slot_kernel.py``). The
numbers are the same: the kernel's forward equals the plain loop.

Exporting an artifact (``export_serving``, ``save_artifact``,
``load_artifact``) and int8 quantisation are not ported yet.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

__all__ = ["make_serving_fn"]


def _render_slot_maps(attn: torch.Tensor, num_classes: int, slots_per_class: int) -> torch.Tensor:
    """(B, S, N) final attention -> (B, C, side, side) uint8, min-max scaled
    per sample over the whole map set (slot_attention.py:78-79 semantics)."""
    b, s, n = attn.shape
    attn = attn.to(torch.float32)
    if slots_per_class > 1:
        attn = attn.reshape(b, num_classes, slots_per_class, n).sum(dim=2)
    amin = attn.amin(dim=(1, 2), keepdim=True)
    amax = attn.amax(dim=(1, 2), keepdim=True)
    scaled = (attn - amin) / (amax - amin + 1e-12) * 255.0
    side = int(round(n ** 0.5))
    return scaled.reshape(b, num_classes, side, side).to(torch.uint8)


def make_serving_fn(cfg, state_dict: Mapping[str, torch.Tensor], *,
                    compute_dtype: Optional[torch.dtype] = None, include_maps: bool = True,
                    device="cuda"):
    """Build ``fn(images_u8) -> dict`` with the weights of ``state_dict``
    (the reference's names; ``models.convert.variables_to_state_dict`` makes
    one from JAX variables) loaded on ``device``.

    ``images_u8`` is a uint8 (B, H, W, C) numpy array or tensor. The result
    holds tensors on ``device``: ``logits`` and, for a slot model with
    ``include_maps``, ``slot_maps``; ``fn.model`` is the served module.
    ``compute_dtype`` (e.g. torch.bfloat16) is the backbone's, computed over
    f32 parameters and BatchNorm statistics as in the JAX package; the slot
    head stays f32 unless ``cfg.slot_head_dtype == 'compute'``."""
    from ..core.config import check_serving_supported
    from ..core.device import resolve_device
    from ..data.transforms import preprocess_batch
    from ..models import build_slot_model

    check_serving_supported(cfg)
    dev = resolve_device(device)
    model = build_slot_model(cfg, fused_slot=True, compute_dtype=compute_dtype, device=dev)
    model.load_state_dict(state_dict)

    def fn(images_u8):
        # inference_mode is thread-local: entered here, in the calling thread
        with torch.inference_mode():
            images = (images_u8 if torch.is_tensor(images_u8)
                      else torch.as_tensor(np.asarray(images_u8))).to(dev)
            x = preprocess_batch(images, dataset=cfg.dataset, img_size=cfg.img_size)
            out = model(x.permute(0, 3, 1, 2))
            result = {"logits": out["logits"].to(torch.float32)}
            if cfg.use_slot and include_maps:
                result["slot_maps"] = _render_slot_maps(
                    out["attn"], cfg.num_classes, cfg.slots_per_class)
            return result

    fn.model = model
    return fn
