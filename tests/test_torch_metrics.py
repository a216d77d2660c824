"""The PyTorch port's PSNR / SSIM against dcpt_tpu's host metrics (float64 numpy,
OpenCV's Gaussian window there, separable 1-D passes here)."""

import numpy as np
import pytest

import _torch_threads  # noqa: F401
from dcpt_tpu.metrics import calculate_metric as jax_calculate_metric
from dcpt_tpu_torch.metrics import calculate_metric


def _pair(shape, seed):
    rng = np.random.default_rng(seed)
    a = rng.random(shape).astype(np.float32)
    b = np.clip(a + rng.normal(0.0, 0.05, shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("crop_border", [0, 3])
@pytest.mark.parametrize("test_y_channel", [False, True])
@pytest.mark.parametrize("metric,tol", [("calculate_psnr", 1e-12), ("calculate_ssim", 1e-9)])
def test_metric_matches_dcpt_tpu(metric, tol, crop_border, test_y_channel):
    a, b = _pair((2, 3, 37, 45), seed=crop_border + 2 * test_y_channel)
    opt = {"type": metric, "crop_border": crop_border, "test_y_channel": test_y_channel, "image_range": 255.0}
    ours = calculate_metric({"img": a, "img2": b}, dict(opt, input_order="BCHW"))
    ref = jax_calculate_metric({"img": a.transpose(0, 2, 3, 1), "img2": b.transpose(0, 2, 3, 1)},
                               dict(opt, input_order="BHWC"))
    assert abs(ours - ref) <= tol, (ours, ref)


@pytest.mark.parametrize("metric", ["calculate_psnr", "calculate_ssim"])
def test_single_channel_and_identical_images(metric):
    a, b = _pair((1, 1, 24, 24), seed=5)
    opt = {"type": metric, "crop_border": 0, "input_order": "BCHW"}
    assert abs(calculate_metric({"img": a, "img2": b}, opt) - jax_calculate_metric({"img": a, "img2": b}, opt)) <= 1e-9
    same = calculate_metric({"img": a, "img2": a}, opt)
    assert same == (float("inf") if metric == "calculate_psnr" else 1.0)
