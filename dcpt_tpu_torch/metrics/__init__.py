"""Metric dispatch (dcpt_tpu/metrics/__init__.py)."""

from copy import deepcopy

from ..utils.registry import METRIC_REGISTRY
from .psnr_ssim import calculate_psnr, calculate_ssim  # noqa: F401  (registers the metrics)

__all__ = ["calculate_metric", "calculate_psnr", "calculate_ssim"]


def calculate_metric(data, opt):
    """Dispatch by ``opt['type']`` through the metric registry."""
    opt = deepcopy(opt)
    metric_type = opt.pop("type")
    return METRIC_REGISTRY.get(metric_type)(**data, **opt)
