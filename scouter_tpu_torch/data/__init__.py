"""Data preprocessing."""

from .transforms import NORMALIZE_VALUES, preprocess_batch, resize_bilinear

__all__ = ["NORMALIZE_VALUES", "preprocess_batch", "resize_bilinear"]
