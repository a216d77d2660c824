"""Crop primitives of the eval path (dcpt_tpu/data/transforms.py), numpy HWC."""

from __future__ import annotations

import numpy as np


def center_crop(img: np.ndarray, size: int) -> np.ndarray:
    """Centred size x size crop (reference: transforms.py:27-45)."""
    if img.ndim not in (2, 3):
        raise ValueError(f"Wrong img ndim: {img.ndim}.")
    h, w = img.shape[0], img.shape[1]
    return img[(h - size) // 2 : (h + size) // 2, (w - size) // 2 : (w + size) // 2, ...].copy()
