"""Shared metric helpers (dcpt_tpu/metrics/metric_util.py)."""

from __future__ import annotations

import numpy as np

from ..utils.color_util import bgr2ycbcr


def reorder_image(img: np.ndarray, input_order: str = "BHWC") -> np.ndarray:
    """Normalise (h,w) / (c,h,w) / (h,w,c) / (b,c,h,w) / (b,h,w,c) to BHWC."""
    if input_order not in ["BHWC", "BCHW"]:
        raise ValueError(f"Wrong input_order {input_order}. Supported: 'BHWC' and 'BCHW'")
    if img.ndim == 2:
        img = img[None, ..., None]
    if input_order == "BCHW":
        if img.ndim == 3:
            img = img.transpose(1, 2, 0)[None, ...]
        elif img.ndim == 4:
            img = img.transpose(0, 2, 3, 1)
    elif img.ndim == 3:
        img = img[None, ...]
    return img


def to_y_channel(img: np.ndarray, image_range: float = 255.0) -> np.ndarray:
    """BGR -> Y channel, keeping the input range, float without rounding."""
    img = img.astype(np.float32) / image_range
    if img.ndim == 3 and img.shape[2] == 3:
        img = bgr2ycbcr(img, y_only=True)[..., None]
    return img * image_range
