"""The weight carrier: the JAX package's flax variables -> this port's state dict.

``variables_to_state_dict`` is the inverse of
``scouter_tpu.models.convert.torch_state_dict_to_variables``: it reads the
``{'params': ..., 'batch_stats': ...}`` tree (leaves as numpy arrays or
anything ``np.asarray`` takes) and returns the torch state dict under the
reference's names, which ``SlotModel.load_state_dict`` accepts:

- conv kernels HWIO -> OIHW, Dense kernels (in, out) -> (out, in)
- ``layer1_0`` -> ``layer1.0``, ``conv1_0`` -> ``conv1.0``, and the nested
  ``downsample/downsample_1`` -> ``downsample.1``
- BatchNorm ``scale`` -> ``weight``, ``mean``/``var`` -> ``running_mean``/
  ``running_var``, plus a zero ``num_batches_tracked``
- xSlot leaves keep torch layout: ``to_k_{i}_weight`` -> ``to_k.{i}.weight``,
  ``gru_w_ih`` -> ``gru.weight_ih_l0``, ...
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

__all__ = ["variables_to_state_dict"]

_GRU_NAMES = {
    "gru_w_ih": "gru.weight_ih_l0",
    "gru_w_hh": "gru.weight_hh_l0",
    "gru_b_ih": "gru.bias_ih_l0",
    "gru_b_hh": "gru.bias_hh_l0",
}
_TO_K = re.compile(r"to_k_(\d+)_(weight|bias)")
_INDEXED = re.compile(r"(.+)_(\d+)")


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _torch_module_path(segments: Tuple[str, ...]) -> str:
    """Split flax names back into torch Sequential indices: layer1_0 ->
    layer1.0; a child ``downsample_1`` of ``downsample`` -> downsample.1."""
    out = []
    for seg in segments:
        m = _INDEXED.fullmatch(seg)
        if m and out and out[-1] == m.group(1):
            out.append(m.group(2))
        elif m:
            out.extend(m.groups())
        else:
            out.append(seg)
    return ".".join(out)


def _tensor(arr) -> torch.Tensor:
    return torch.tensor(np.asarray(arr), dtype=torch.float32)


def variables_to_state_dict(variables: Mapping[str, Mapping]) -> Dict[str, torch.Tensor]:
    """Convert flax ``{'params', 'batch_stats'}`` variables into a torch state dict."""
    sd: Dict[str, torch.Tensor] = {}
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
        mod = _torch_module_path(path[:-1])
        if name == "kernel" and arr.ndim == 4:  # HWIO -> OIHW
            sd[f"{mod}.weight"] = _tensor(arr.transpose(3, 2, 0, 1))
        elif name == "kernel" and arr.ndim == 2:  # (in, out) -> (out, in)
            sd[f"{mod}.weight"] = _tensor(arr.T)
        elif name == "scale":
            sd[f"{mod}.weight"] = _tensor(arr)
        elif name == "bias":
            sd[f"{mod}.bias"] = _tensor(arr)
        else:
            raise KeyError(f"unrecognized leaf {'/'.join(path)!r} of shape {arr.shape}")
    for path, leaf in _leaves(variables.get("batch_stats", {})):
        mod = _torch_module_path(path[:-1])
        if path[-1] == "mean":
            sd[f"{mod}.running_mean"] = _tensor(leaf)
            sd[f"{mod}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
        elif path[-1] == "var":
            sd[f"{mod}.running_var"] = _tensor(leaf)
        else:
            raise KeyError(f"unrecognized batch_stats leaf {'/'.join(path)!r}")
    return sd
