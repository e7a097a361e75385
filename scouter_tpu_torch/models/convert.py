"""The weight carrier: the JAX package's flax variables -> this port's state dict.

``variables_to_state_dict`` is the inverse of
``scouter_tpu.models.convert.torch_state_dict_to_variables``: it reads the
``{'params': ..., 'batch_stats': ...}`` tree (leaves as numpy arrays or
anything ``np.asarray`` takes) and returns the torch state dict under the
reference's names, which ``SlotModel.load_state_dict`` accepts:

- conv kernels HWIO -> OIHW, Conv1d kernels (k, in, out) -> (out, in, k)
  (ECA's), Dense kernels (in, out) -> (out, in)
- each module is the one among ``names``, the keys of the state dict to
  fill, that the JAX package's converter names so (its ``_module_path``:
  ``layer1.0`` -> ``layer1_0``, ``blocks.2.1`` -> ``blocks_2_1``,
  ``downsample.1`` -> ``downsample/downsample_1``). That converter writes
  an attribute ``cell_0`` and a container index ``cell.0`` alike, so a
  ``_<digits>`` tail that belongs to timm's attribute name (DPN's
  ``conv2_1``, Inception's ``branch3x3dbl_1``, NASNet's ``cell_stem_0``,
  Inception-ResNet's ``repeat_1.0``) is read as the model declares it; a
  module no key declares has every ``_<digits>`` tail split into indices
- an EvoNorm's ``scale``, ``bias`` and ``v`` (C,) -> timm's (1, C, 1, 1);
  a CondConv ``kernel`` (params, experts) -> ``weight`` (experts, params)
- BatchNorm ``scale`` -> ``weight``, ``mean``/``var`` -> ``running_mean``/
  ``running_var``, plus a zero ``num_batches_tracked``
- xSlot leaves keep torch layout: ``to_k_{i}_weight`` -> ``to_k.{i}.weight``,
  ``gru_w_ih`` -> ``gru.weight_ih_l0``, ...

``strip_prefix``, ``prepare_pretrained_state_dict`` and ``merge_variables``
are the JAX package's pretrained-weight helpers (``convert.py:36-84``) on
torch state dicts: the prefix handoff, timm's in_chans and classifier
adjustments, and the overlay that keeps the init where a checkpoint has
nothing.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterable, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "merge_variables",
    "prepare_pretrained_state_dict",
    "readout_params_to_state_dict",
    "strip_prefix",
    "variables_to_state_dict",
]

_GRU_NAMES = {
    "gru_w_ih": "gru.weight_ih_l0",
    "gru_w_hh": "gru.weight_hh_l0",
    "gru_b_ih": "gru.bias_ih_l0",
    "gru_b_hh": "gru.bias_hh_l0",
}
_TO_K = re.compile(r"to_k_(\d+)_(weight|bias)")
_INDEXED = re.compile(r"(.+?)((?:_\d+)+)")


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _torch_module_path(segments: Tuple[str, ...]) -> str:
    """Split flax names back into torch container indices: layer1_0 ->
    layer1.0, blocks_2_1 -> blocks.2.1; a child ``downsample_1`` of
    ``downsample`` -> downsample.1."""
    out = []
    for seg in segments:
        m = _INDEXED.fullmatch(seg)
        if m:
            base, indices = m.group(1), m.group(2)[1:].split("_")
            out.extend(indices if out and out[-1] == base else [base] + indices)
        else:
            out.append(seg)
    return ".".join(out)


def _flax_module_path(segments) -> Tuple[str, ...]:
    """The JAX package's ``_module_path`` (``scouter_tpu/models/convert.py:
    101-117``): an integer index joins the name before it (``layer1.0`` ->
    ``layer1_0``), except under ``downsample``, where it opens a level of its
    own (``downsample.1`` -> ``downsample/downsample_1``)."""
    out = []
    for seg in segments:
        if seg.isdigit() and out:
            merged = f"{out[-1]}_{seg}"
            if out[-1] == "downsample":
                out.append(merged)
            else:
                out[-1] = merged
        else:
            out.append(seg)
    return tuple(out)


def _declared_modules(names: Iterable[str]) -> Dict[Tuple[str, ...], str]:
    """The flax path of each module that holds a tensor of ``names``, to that
    module's torch path."""
    out: Dict[Tuple[str, ...], str] = {}
    for key in names:
        mod = key.rpartition(".")[0]
        if not mod:
            continue
        flax = _flax_module_path(mod.split("."))
        if out.setdefault(flax, mod) != mod:
            raise ValueError(f"modules {out[flax]!r} and {mod!r} share the flax name "
                             f"{'/'.join(flax)!r}")
    return out


def _tensor(arr) -> torch.Tensor:
    return torch.tensor(np.asarray(arr), dtype=torch.float32)


def variables_to_state_dict(variables: Mapping[str, Mapping],
                            names: Iterable[str]) -> Dict[str, torch.Tensor]:
    """Convert flax ``{'params', 'batch_stats'}`` variables into a torch state
    dict whose keys are among ``names`` (e.g. the target model's
    ``state_dict()``): each module is resolved against the ones the model
    declares, where a flax name has two readings."""
    sd: Dict[str, torch.Tensor] = {}
    declared = _declared_modules(names)

    def module_path(path: Tuple[str, ...]) -> str:
        return declared.get(path) or _torch_module_path(path)

    # EvoNorm layers are the modules with a ``v`` gate; their leaves take
    # timm's (1, C, 1, 1)
    evo = {path[:-1] for path, _ in _leaves(variables.get("params", {})) if path[-1] == "v"}
    for path, leaf in _leaves(variables.get("params", {})):
        arr = np.asarray(leaf)
        name = path[-1]
        if "slot" in path[:-1]:
            base = _torch_module_path(path[:path.index("slot") + 1])
            m = _TO_K.fullmatch(name)
            if name == "initial_slots":
                sd[f"{base}.initial_slots"] = _tensor(arr)
            elif m:
                sd[f"{base}.to_k.{m.group(1)}.{m.group(2)}"] = _tensor(arr)
            elif name in _GRU_NAMES:
                sd[f"{base}.{_GRU_NAMES[name]}"] = _tensor(arr)
            else:
                raise KeyError(f"unrecognized slot leaf {'/'.join(path)!r}")
            continue
        mod = module_path(path[:-1])
        if path[:-1] in evo:
            if name not in ("scale", "bias", "v"):
                raise KeyError(f"unrecognized EvoNorm leaf {'/'.join(path)!r}")
            sd[f"{mod}.{'weight' if name == 'scale' else name}"] = _tensor(
                arr.reshape(1, -1, 1, 1))
        elif name == "kernel" and arr.ndim == 4:  # HWIO -> OIHW
            sd[f"{mod}.weight"] = _tensor(arr.transpose(3, 2, 0, 1))
        elif name == "kernel" and arr.ndim == 3:  # Conv1d (k, in, out) -> (out, in, k)
            sd[f"{mod}.weight"] = _tensor(arr.transpose(2, 1, 0))
        elif name == "kernel" and arr.ndim == 2:
            # Dense (in, out) -> (out, in); CondConv (params, experts) -> (experts, params)
            sd[f"{mod}.weight"] = _tensor(arr.T)
        elif name == "scale":
            sd[f"{mod}.weight"] = _tensor(arr)
        elif name == "bias":
            sd[f"{mod}.bias"] = _tensor(arr)
        else:
            raise KeyError(f"unrecognized leaf {'/'.join(path)!r} of shape {arr.shape}")
    for path, leaf in _leaves(variables.get("batch_stats", {})):
        mod = module_path(path[:-1])
        if path[-1] == "mean":
            sd[f"{mod}.running_mean"] = _tensor(leaf)
            sd[f"{mod}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
        elif path[-1] == "var":
            sd[f"{mod}.running_var"] = _tensor(leaf)
        else:
            raise KeyError(f"unrecognized batch_stats leaf {'/'.join(path)!r}")
    return sd


def readout_params_to_state_dict(variables: Mapping[str, Mapping]) -> Dict[str, torch.Tensor]:
    """A flax ``ReadoutNet``'s ``{'params': {conv1, conv2, conv3}}`` (the JAX
    package's ``explain/iba_readout.py``) as the state dict of the port's
    ``explain.iba_readout.ReadoutNet``: HWIO kernels to OIHW."""
    expected = {f"conv{i}.{p}" for i in (1, 2, 3) for p in ("weight", "bias")}
    sd = variables_to_state_dict({"params": variables["params"]}, expected)
    if set(sd) != expected:
        raise KeyError(f"not a ReadoutNet's parameters: {sorted(sd)}")
    return sd


def strip_prefix(state_dict: Mapping[str, Any], prefix: str = "backbone.") -> Dict[str, Any]:
    """The entries under ``prefix``, the prefix removed: the ``k[9:]``
    handoff of ``sloter/slot_model.py:27-33``."""
    return {k[len(prefix):]: v for k, v in state_dict.items() if k.startswith(prefix)}


def prepare_pretrained_state_dict(
    state_dict: Mapping[str, Any],
    *,
    in_chans: int = 3,
    num_classes: Optional[int] = None,
    pretrained_classes: int = 1000,
    first_conv: str = "conv1",
    classifier: str = "fc",
) -> Dict[str, Any]:
    """timm's ``load_pretrained`` weight adjustments (``timm/models/helpers.py:68-101``):

    - ``in_chans == 1``: the first conv's RGB kernel collapses by a sum over
      its input channels (:75-80);
    - a head with an extra background class (1001 -> 1000) loses row 0 of
      the classifier's weight and bias (:85-91);
    - any other class-count mismatch drops the classifier (:92-96), so the
      model keeps its own.
    """
    sd = dict(state_dict)
    if in_chans == 1:
        sd[first_conv + ".weight"] = torch.as_tensor(sd[first_conv + ".weight"]).sum(
            dim=1, keepdim=True)
    elif in_chans != 3:
        raise ValueError("pretrained weights support in_chans of 1 or 3 only")
    if num_classes is not None and num_classes != pretrained_classes:
        if num_classes == 1000 and pretrained_classes == 1001:
            for leaf in ("weight", "bias"):
                sd[f"{classifier}.{leaf}"] = torch.as_tensor(sd[f"{classifier}.{leaf}"])[1:]
        else:
            sd.pop(classifier + ".weight", None)
            sd.pop(classifier + ".bias", None)
    return sd


def merge_variables(init: Mapping[str, Any], loaded: Mapping[str, Any]) -> Dict[str, Any]:
    """``loaded`` overlaid on ``init``, the ``strict=False`` load
    (helpers.py:96-101): what ``loaded`` lacks keeps its init, and what
    ``init`` lacks is dropped. Nested mappings (variable trees) merge
    recursively; a flat state dict merges key by key."""
    out: Dict[str, Any] = {}
    for k, v in init.items():
        if k in loaded and isinstance(v, Mapping) and isinstance(loaded[k], Mapping):
            out[k] = merge_variables(v, loaded[k])
        else:
            out[k] = loaded.get(k, v)
    return out
