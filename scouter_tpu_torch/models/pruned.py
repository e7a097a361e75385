"""Pruned-channel widths (counterpart of ``scouter_tpu/models/pruned.py``),
the capability of timm's ``adapt_model_from_file``
(``timm/models/helpers.py:146-196``).

timm builds the full model and then rewrites each Conv2d, BatchNorm2d and
Linear to the widths listed in ``timm/models/pruned/{variant}.txt``. Here
the blocks are built at those widths directly: a table of conv
out-channels, looked up when a conv is built, and every input width
follows from the output before it. The Conv1d of ECA is not a Conv2d, so
timm's surgery leaves it, and its kernel size stays derived from the
unpruned channel count; the blocks keep that quirk by passing the
unpruned width to the attention modules.

``pruned_data/{variant}.json`` holds the out-channel tables (conv2d
entries only), the port's own copies of the JAX package's.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional, Tuple

__all__ = ["load_pruned_widths", "WidthOverrides", "scope_widths", "width_of"]

# a sorted tuple of (torch conv prefix, out_channels) pairs, or None
WidthOverrides = Optional[Tuple[Tuple[str, int], ...]]

_DATA_DIR = Path(__file__).resolve().parent / "pruned_data"


def load_pruned_widths(variant: str) -> Tuple[Tuple[str, int], ...]:
    """The out-channel table of a pruned variant, as sorted (conv prefix,
    out_channels) pairs."""
    table: Dict[str, int] = json.loads((_DATA_DIR / f"{variant}.json").read_text())
    return tuple(sorted(table.items()))


def scope_widths(widths: WidthOverrides, prefix: str) -> WidthOverrides:
    """The sub-table of one block: keys under ``prefix.``, the prefix
    stripped."""
    if not widths:
        return None
    p = prefix + "."
    sub = tuple((k[len(p):], v) for k, v in widths if k.startswith(p))
    return sub or None


def width_of(widths: WidthOverrides, key: str, default: int) -> int:
    """The table's width for ``key``, else the unpruned ``default``."""
    for k, v in widths or ():
        if k == key:
            return v
    return default
