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
because XLA fuses those ops with their neighbours and a Pallas call would pin
its artifact to one backend; eager PyTorch has no such fusion, so on the card
the slot head runs through the hand-written xSlot kernel
(``ops/slot_kernel.py``). The numbers are the same: the kernel's forward
equals the plain loop.

``quant='int8'`` installs the hybrid int8 policy of ``serve/quant.py`` on the
built model: its pointwise backbone convs run s8 x s8 -> s32.

The artifact (``export_serving``, ``save_artifact``, ``load_artifact``) is a
``torch.export.ExportedProgram`` of the whole serving function, the weights
in it, saved with ``torch.export.save``. K1 and K2 are ``torch.library``
custom ops with fake implementations, so the program holds them as ops
(``scouter_tpu_torch::xslot_fwd``) and a loaded artifact launches the same
kernels, counted as the live function's are. Differences from ``jax.export``:
- one program a device kind: ``platforms`` names ``cuda``, ``cpu`` or both,
  and an artifact of both holds one ``ExportedProgram`` for each (a zip of
  their ``torch.export.save`` archives and a ``platforms.json`` naming
  them), where StableHLO holds several backends in one program;
  ``load_artifact`` takes the program for its device's kind;
- an artifact runs under the torch that wrote it (the ``torch.export``
  format is not promised across versions); ``load_artifact`` needs the
  port's ops imported, which it does itself;
- a dynamic batch is a ``torch.export.Dim`` from 2 to 65535
  (``BATCH_RANGE``): torch 2.11 on the card guards a traced batch to at
  least 2 (it specialises sizes 0 and 1) and at most 65535 (a CUDA grid
  limit). Batch 1 still runs through the dynamic artifact: ``load_artifact``'s
  call pads it with a zero image to the artifact's least batch and drops that
  row, which is exact, as every op of the serving function in eval mode is
  per sample. A pinned artifact refuses other sizes.
"""

from __future__ import annotations

import io
import json
import os
import zipfile
from typing import Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

__all__ = ["BATCH_RANGE", "DEVICE_KINDS", "ServingModule", "artifact_platforms",
           "export_serving", "load_artifact", "make_serving_fn", "save_artifact"]

# the batch sizes a dynamic artifact is traced for (the module docstring)
BATCH_RANGE = (2, 65535)
# the device kinds an artifact may hold programs for, and the member of a
# several-kind artifact that names them
DEVICE_KINDS = ("cuda", "cpu")
_MANIFEST = "platforms.json"


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


class ServingModule(nn.Module):
    """The serving function as a module (what ``export_serving`` traces):
    uint8 (B, H, W, C) images -> {"logits" (B, classes) f32, and for a slot
    model with ``include_maps`` "slot_maps" (B, classes, side, side) uint8}."""

    def __init__(self, cfg, model: nn.Module, include_maps: bool = True):
        super().__init__()
        self.model = model
        self.dataset, self.img_size = cfg.dataset, cfg.img_size
        self.num_classes, self.slots_per_class = cfg.num_classes, cfg.slots_per_class
        self.maps = bool(cfg.use_slot and include_maps)

    def forward(self, images_u8: torch.Tensor):
        from ..data.transforms import preprocess_batch

        x = preprocess_batch(images_u8, dataset=self.dataset, img_size=self.img_size)
        out = self.model(x.permute(0, 3, 1, 2))
        result = {"logits": out["logits"].to(torch.float32)}
        if self.maps:
            result["slot_maps"] = _render_slot_maps(out["attn"], self.num_classes,
                                                    self.slots_per_class)
        return result


def _serving_module(cfg, state_dict, compute_dtype, include_maps, dev,
                    quant: Optional[str] = None,
                    backbone_kwargs: Optional[dict] = None) -> ServingModule:
    """The eval-mode ``ServingModule`` with ``state_dict``'s weights on
    ``dev``, its parameters out of autograd, the ``quant`` policy on it."""
    from ..core.config import check_serving_supported
    from ..models import build_slot_model
    from ..models.layers import set_conv_policy
    from .quant import policy_of

    check_serving_supported(cfg)
    policy = policy_of(quant) if quant else None
    model = build_slot_model(cfg, fused_slot=True, compute_dtype=compute_dtype, device=dev,
                             backbone_kwargs=backbone_kwargs)
    model.load_state_dict(state_dict)
    model.requires_grad_(False)
    if policy is not None and set_conv_policy(model, policy) == 0:
        raise ValueError(f"the {quant!r} policy covers no conv of {cfg.model}")
    return ServingModule(cfg, model, include_maps).eval()


def _as_images(images_u8, dev) -> torch.Tensor:
    return (images_u8 if torch.is_tensor(images_u8)
            else torch.as_tensor(np.asarray(images_u8))).to(dev)


def make_serving_fn(cfg, state_dict: Mapping[str, torch.Tensor], *,
                    compute_dtype: Optional[torch.dtype] = None, include_maps: bool = True,
                    quant: Optional[str] = None, device="cuda",
                    backbone_kwargs: Optional[dict] = None):
    """Build ``fn(images_u8) -> dict`` with the weights of ``state_dict``
    (the reference's names; ``models.convert.variables_to_state_dict`` makes
    one from JAX variables) loaded on ``device``.

    ``images_u8`` is a uint8 (B, H, W, C) numpy array or tensor. The result
    holds tensors on ``device``: ``logits`` and, for a slot model with
    ``include_maps``, ``slot_maps``; ``fn.model`` is the served model and
    ``fn.module`` the ``ServingModule`` around it. ``compute_dtype`` (e.g.
    torch.bfloat16) is the backbone's, computed over f32 parameters and
    BatchNorm statistics as in the JAX package; the slot head computes in
    f32 unless ``cfg.slot_head_dtype == 'compute'``. ``quant='int8'`` runs
    the backbone's pointwise convs in int8 (``serve/quant.py``).
    ``backbone_kwargs`` go to ``build_slot_model`` (e.g. ``{"output_stride":
    8}`` or ``{"s2d_stem": True}``), which the config does not name."""
    from ..core.device import resolve_device

    dev = resolve_device(device)
    module = _serving_module(cfg, state_dict, compute_dtype, include_maps, dev, quant,
                             backbone_kwargs)

    def fn(images_u8):
        # inference_mode is thread-local: entered here, in the calling thread
        with torch.inference_mode():
            return module(_as_images(images_u8, dev))

    fn.model, fn.module = module.model, module
    return fn


def _platforms(platforms: Union[None, str, Sequence[str]], device) -> Tuple[str, ...]:
    """The device kinds an artifact is for: ``platforms`` (``cuda``, ``cpu``
    or both, each once) where given, else ``device``'s."""
    if platforms is None:
        return (torch.device(device).type,)
    kinds = (platforms,) if isinstance(platforms, str) else tuple(platforms)
    if not kinds or len(set(kinds)) != len(kinds) or not set(kinds) <= set(DEVICE_KINDS):
        raise ValueError(f"platforms names device kinds out of {DEVICE_KINDS}, each once, got "
                         f"{platforms!r}")
    return kinds


def export_serving(cfg, state_dict: Mapping[str, torch.Tensor], *, batch: Optional[int] = None,
                   platforms=None, compute_dtype: Optional[torch.dtype] = None,
                   include_maps: bool = True, device="cuda"):
    """Export the serving function: a ``torch.export.ExportedProgram`` of
    preprocess, model and maps with the weights in it, for the device kind
    ``platforms`` names (else ``device``'s); where it names both kinds, a
    dict of one program per kind. ``batch=None`` exports a dynamic batch
    (``BATCH_RANGE``; ``load_artifact`` pads a batch of 1), an int pins
    it."""
    from ..core.device import resolve_device

    programs = {}
    for kind in _platforms(platforms, device):
        dev = resolve_device(kind)
        module = _serving_module(cfg, state_dict, compute_dtype, include_maps, dev)
        channels = 1 if cfg.dataset == "MNIST" else 3
        example = torch.zeros((2 if batch is None else int(batch), cfg.img_size, cfg.img_size,
                               channels), dtype=torch.uint8, device=dev)
        dynamic = None if batch is not None else (
            {0: torch.export.Dim("batch", min=BATCH_RANGE[0], max=BATCH_RANGE[1])},)
        programs[kind] = torch.export.export(module, (example,), dynamic_shapes=dynamic)
    return programs.popitem()[1] if len(programs) == 1 else programs


def save_artifact(exported, path: str) -> int:
    """Write an ExportedProgram to ``path`` (``torch.export.save``), or a
    dict of one per device kind as one zip of their archives with a
    manifest; returns the byte size."""
    if not isinstance(exported, Mapping):
        torch.export.save(exported, path)
        return os.path.getsize(path)
    for kind, program in exported.items():
        if artifact_platform(program) != kind:
            raise ValueError(f"the program given for {kind} holds tensors on "
                             f"{artifact_platform(program)}")
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as archive:
        archive.writestr(_MANIFEST, json.dumps({"platforms": list(exported)}))
        for kind, program in exported.items():
            buf = io.BytesIO()
            torch.export.save(program, buf)
            archive.writestr(f"{kind}.pt2", buf.getvalue())
    return os.path.getsize(path)


def artifact_platform(exported) -> str:
    """The device kind an ExportedProgram's weights live on."""
    tensors = list(exported.state_dict.values()) + list(exported.constants.values())
    kinds = {t.device.type for t in tensors if torch.is_tensor(t)}
    if len(kinds) != 1:
        raise ValueError(f"artifact holds tensors on {sorted(kinds)}, not one device kind")
    return kinds.pop()


def artifact_platforms(path: str) -> Tuple[str, ...]:
    """The device kinds the artifact at ``path`` holds programs for."""
    with zipfile.ZipFile(path) as archive:
        if _MANIFEST in archive.namelist():
            return tuple(json.loads(archive.read(_MANIFEST))["platforms"])
    return (artifact_platform(torch.export.load(path)),)


def _load_program(path: str, kind: str):
    """The ExportedProgram at ``path`` for device kind ``kind``: the file's
    one program, or its member for ``kind``; another kind raises and names
    the kinds the file holds."""
    with zipfile.ZipFile(path) as archive:
        if _MANIFEST in archive.namelist():
            kinds = json.loads(archive.read(_MANIFEST))["platforms"]
            if kind not in kinds:
                raise ValueError(f"{path} holds programs for {kinds}, not for {kind}")
            return torch.export.load(io.BytesIO(archive.read(f"{kind}.pt2")))
    exported = torch.export.load(path)
    held = artifact_platform(exported)
    if held != kind:
        raise ValueError(f"{path} holds a program for {[held]} (it was exported for {held}), "
                         f"not for {kind}")
    return exported


def batch_range(exported):
    """(least batch, pinned) of an ExportedProgram: its dynamic batch
    dimension's lower bound, or the pinned batch."""
    user_inputs = set(exported.graph_signature.user_inputs)
    node = next(n for n in exported.graph.nodes if n.op == "placeholder" and n.name in user_inputs)
    b = node.meta["val"].shape[0]
    if isinstance(b, int):
        return b, True
    return int(exported.range_constraints[b.node.expr].lower), False


def load_artifact(path: str, device="cuda"):
    """Load an artifact; returns ``call(images_u8) -> dict`` (under
    inference mode, on ``device``) with ``call.exported`` the program. The
    artifact must hold a program for ``device``'s kind (its one program, or
    one of several), else ``ValueError`` naming the kinds it holds; the
    program's input shape guards refuse other image sizes (and another
    batch, where it is pinned). A dynamic artifact's call pads a batch below
    its least (1) with zero images and drops their rows."""
    from .. import ops  # noqa: F401  (registers the custom ops the program calls)
    from ..core.device import resolve_device

    exported = _load_program(path, torch.device(device).type)
    dev = resolve_device(device)
    module = exported.module()
    low, pinned = batch_range(exported)

    def call(images_u8):
        with torch.inference_mode():
            images = _as_images(images_u8, dev)
            n = images.shape[0]
            if pinned or n >= low:
                return module(images)
            pad = images.new_zeros((low - n, *images.shape[1:]))
            return {k: v[:n] for k, v in module(torch.cat([images, pad])).items()}

    call.exported = exported
    return call
