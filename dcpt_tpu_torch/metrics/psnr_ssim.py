"""PSNR / SSIM on host numpy in float64 (dcpt_tpu/metrics/psnr_ssim.py, host path).

The reference protocol (basicsr/metrics/psnr_ssim.py:12-183): float images in
[0, 1] are quantised through uint8 / uint16 at ``image_range``, swapped
RGB -> BGR, optionally cropped and reduced to the Y channel, then scored in
float64.  SSIM's 11 x 11 Gaussian window (sigma 1.5) is applied as two 1-D
passes over the valid region, where the reference uses cv2.filter2D.
"""

from __future__ import annotations

import numpy as np

from ..utils.registry import METRIC_REGISTRY
from .metric_util import reorder_image, to_y_channel


def _quantize_pair(img: np.ndarray, img2: np.ndarray, image_range: float, crop_border: int, test_y_channel: bool):
    """The shared pre-processing of the numpy metrics (psnr_ssim.py:53-67)."""
    dtype = np.uint8 if image_range == 255 else np.uint16
    if image_range != 1:
        img = (img * float(image_range)).round().astype(dtype)
        img2 = (img2 * float(image_range)).round().astype(dtype)
    if img.shape[-1] == img2.shape[-1] == 3:
        img, img2 = img[..., ::-1], img2[..., ::-1]
    if crop_border != 0:
        img = img[crop_border:-crop_border, crop_border:-crop_border, ...]
        img2 = img2[crop_border:-crop_border, crop_border:-crop_border, ...]
    if test_y_channel and img.shape[-1] == img2.shape[-1] == 3:
        img = to_y_channel(img, image_range)
        img2 = to_y_channel(img2, image_range)
    return img.astype(np.float64), img2.astype(np.float64)


@METRIC_REGISTRY.register()
def calculate_psnr(img, img2, crop_border, input_order="BCHW", test_y_channel=False, image_range=255, **kwargs):
    """Batch-mean PSNR with the uint8/uint16 round-trip (reference: psnr_ssim.py:12-75)."""
    if img.shape != img2.shape:
        raise ValueError(f"Image shapes are different: {img.shape}, {img2.shape}.")
    imgs = reorder_image(np.asarray(img), input_order=input_order)
    imgs2 = reorder_image(np.asarray(img2), input_order=input_order)
    psnrs = []
    for i in range(imgs.shape[0]):
        a, b = _quantize_pair(imgs[i], imgs2[i], image_range, crop_border, test_y_channel)
        mse = np.mean((a - b) ** 2)
        if mse == 0:
            return float("inf")
        psnrs.append(10.0 * np.log10(image_range * image_range / mse))
    return float(np.array(psnrs).mean())


def _gaussian_1d(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    """cv2.getGaussianKernel(size, sigma) for sigma > 0."""
    x = np.arange(size, dtype=np.float64) - (size - 1) * 0.5
    k = np.exp(-0.5 / (sigma * sigma) * x * x)
    return k * (1.0 / k.sum())


def _filter_valid(img: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Correlation with the separable window outer(k, k), valid region only."""
    n = len(k)
    h, w = img.shape
    rows = sum(k[i] * img[i : h - n + 1 + i, :] for i in range(n))
    return sum(k[j] * rows[:, j : w - n + 1 + j] for j in range(n))


def _ssim_single(img: np.ndarray, img2: np.ndarray, image_range: float = 255) -> float:
    """Single-channel MATLAB SSIM, 11 x 11 Gaussian, valid region (psnr_ssim.py:483-512)."""
    c1 = (0.01 * image_range) ** 2
    c2 = (0.03 * image_range) ** 2
    k = _gaussian_1d()
    mu1 = _filter_valid(img, k)
    mu2 = _filter_valid(img2, k)
    mu1_sq, mu2_sq, mu1_mu2 = mu1**2, mu2**2, mu1 * mu2
    sigma1_sq = _filter_valid(img**2, k) - mu1_sq
    sigma2_sq = _filter_valid(img2**2, k) - mu2_sq
    sigma12 = _filter_valid(img * img2, k) - mu1_mu2
    cs_map = (2 * sigma12 + c2) / (sigma1_sq + sigma2_sq + c2)
    ssim_map = ((2 * mu1_mu2 + c1) / (mu1_sq + mu2_sq + c1)) * cs_map
    return ssim_map.mean()


@METRIC_REGISTRY.register()
def calculate_ssim(img, img2, crop_border, input_order="BCHW", test_y_channel=False, image_range=255, **kwargs):
    """Per-channel-mean MATLAB SSIM (reference: psnr_ssim.py:114-183)."""
    if img.shape != img2.shape:
        raise ValueError(f"Image shapes are different: {img.shape}, {img2.shape}.")
    imgs = reorder_image(np.asarray(img), input_order=input_order)
    imgs2 = reorder_image(np.asarray(img2), input_order=input_order)
    ssims = []
    for i in range(imgs.shape[0]):
        a, b = _quantize_pair(imgs[i], imgs2[i], image_range, crop_border, test_y_channel)
        for j in range(a.shape[2]):
            ssims.append(_ssim_single(a[..., j], b[..., j], image_range))
    return float(np.array(ssims).mean())
