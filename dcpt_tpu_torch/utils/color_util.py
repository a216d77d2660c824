"""Colorspace conversions, MATLAB-faithful BT.601 (dcpt_tpu/utils/color_util.py)."""

from __future__ import annotations

import numpy as np

# MATLAB rgb2ycbcr matrix (rows produce Y, Cb, Cr from R, G, B), plus offsets.
_RGB2YCBCR_MAT = np.array([[65.481, -37.797, 112.0], [128.553, -74.203, -93.786], [24.966, 112.0, -18.214]])
_YCBCR_OFFSET = np.array([16, 128, 128])


def _convert_input_type_range(img: np.ndarray) -> tuple[np.ndarray, str]:
    img_type = img.dtype
    img = img.astype(np.float32)
    if img_type == np.uint8:
        img /= 255.0
    elif img_type != np.float32:
        raise TypeError(f"The img type should be np.float32 or np.uint8, but got {img_type}")
    return img, str(img_type)


def _convert_output_type_range(img: np.ndarray, dst_type: str) -> np.ndarray:
    if dst_type == "uint8":
        return img.round().astype(np.uint8)
    return (img / 255.0).astype(np.float32)


def bgr2ycbcr(img: np.ndarray, y_only: bool = False) -> np.ndarray:
    """BGR -> YCbCr, MATLAB-equivalent; Y in [16, 235] for [0, 255] inputs."""
    img, img_type = _convert_input_type_range(img)
    if y_only:
        out = np.dot(img, _RGB2YCBCR_MAT[::-1, 0]) + 16.0
    else:
        out = np.matmul(img, _RGB2YCBCR_MAT[::-1]) + _YCBCR_OFFSET
    return _convert_output_type_range(out, img_type)
