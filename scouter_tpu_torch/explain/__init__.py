"""Explanations (counterpart of ``scouter_tpu/explain``): per-slot heatmap
rendering, jet overlays and area ratios (``vis``), the test.py CLI
(``cli``), and the XAI baseline suite:

- cam:          CAM, Grad-CAM, Grad-CAM++, Smooth Grad-CAM++, Score-CAM,
                SS-CAM, IS-CAM
- backprop:     gradient, deconvnet, guided backprop, linear approximation
- excitation:   excitation backprop and its contrastive variant
- deeplift:     DeepLift (rescale), input- and layer-level
- rise:         RISE masked-forward saliency
- extremal:     extremal perturbation (blur/fade pyramids, imsmooth)
- igos:         IGOS mask optimisation, deletion/insertion curves
- iba, iba_readout: information bottleneck attribution (per-sample, readout)
- pointing_game, benchmark, datasets, benchmark_models: the pointing-game
                benchmark, its result store, VOC/COCO adapters and the
                caffe VGG16/ResNet50 reference models
- image_utils, parity: torchray's image helpers, heatmap-IoU metrics
- compare_cli:  the torchcam_vis/captum_vis comparison driver
"""

from .vis import (
    apply_colormap_on_image,
    attention_area_ratio,
    attention_to_maps,
    save_slot_pngs,
)

__all__ = [
    "apply_colormap_on_image",
    "attention_area_ratio",
    "attention_to_maps",
    "save_slot_pngs",
]
