"""CSV experiment summary (counterpart of ``scouter_tpu/utils/summary.py``,
timm's ``update_summary``, ``timm/utils.py:198-206``): one row per epoch with
train_/eval_-prefixed metrics."""

from __future__ import annotations

import csv
import os
from collections import OrderedDict
from typing import Dict

__all__ = ["update_summary"]


def update_summary(epoch: int, train_metrics: Dict, eval_metrics: Dict,
                   filename: str, write_header: bool = False) -> None:
    rowd = OrderedDict(epoch=epoch)
    rowd.update([("train_" + k, v) for k, v in train_metrics.items()])
    rowd.update([("eval_" + k, v) for k, v in eval_metrics.items()])
    write_header = write_header or not os.path.exists(filename)
    with open(filename, mode="a") as f:
        writer = csv.DictWriter(f, fieldnames=rowd.keys())
        if write_header:
            writer.writeheader()
        writer.writerow(rowd)
