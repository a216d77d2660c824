"""Restoration and classification losses (dcpt_tpu/losses/basic_loss.py), NCHW tensors.

L1Loss, MSELoss, PSNRLoss and CrossEntropyLoss, with ``loss_weight`` and
``reduction`` as in dcpt_tpu.  The other losses are not ported yet.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..utils.registry import LOSS_REGISTRY
from .loss_util import weighted_loss

_reduction_modes = ["none", "mean", "sum"]


def _check_reduction(reduction: str) -> None:
    if reduction not in _reduction_modes:
        raise ValueError(f"Unsupported reduction mode: {reduction}. Supported ones are: {_reduction_modes}")


@weighted_loss
def l1_loss(pred, target):
    return (pred - target).abs()


@weighted_loss
def mse_loss(pred, target):
    return (pred - target) ** 2


@LOSS_REGISTRY.register()
class L1Loss:
    def __init__(self, loss_weight=1.0, reduction="mean"):
        _check_reduction(reduction)
        self.loss_weight = loss_weight
        self.reduction = reduction

    def __call__(self, pred, target, weight=None, **kwargs):
        return self.loss_weight * l1_loss(pred, target, weight, reduction=self.reduction)


@LOSS_REGISTRY.register()
class MSELoss:
    def __init__(self, loss_weight=1.0, reduction="mean"):
        _check_reduction(reduction)
        self.loss_weight = loss_weight
        self.reduction = reduction

    def __call__(self, pred, target, weight=None, **kwargs):
        return self.loss_weight * mse_loss(pred, target, weight, reduction=self.reduction)


@LOSS_REGISTRY.register()
class CrossEntropyLoss:
    """Softmax cross entropy over class logits (reference: basic_loss.py:39-53)."""

    def __init__(self, loss_weight=1.0, reduction="mean"):
        _check_reduction(reduction)
        self.loss_weight = loss_weight
        self.reduction = reduction

    def __call__(self, pred, target, **kwargs):
        return self.loss_weight * F.cross_entropy(pred, target.long(), reduction=self.reduction)


@LOSS_REGISTRY.register()
class PSNRLoss:
    """scale * log(MSE + 1e-8), NAFNet's training loss (reference: basic_loss.py:338-365)."""

    def __init__(self, loss_weight=1.0, reduction="mean", toY=False):
        if reduction != "mean":
            raise ValueError(f"PSNRLoss supports reduction 'mean' only, got {reduction!r}")
        self.loss_weight = loss_weight
        self.scale = 10 / math.log(10)
        self.toY = toY
        self.coef = torch.tensor([65.481, 128.553, 24.966]).reshape(1, 3, 1, 1)

    def __call__(self, pred, target, weight=None, **kwargs):
        if pred.dim() != 4:
            raise ValueError(f"PSNRLoss takes (N, C, H, W), got {tuple(pred.shape)}")
        if self.toY:
            coef = self.coef.to(pred.device, pred.dtype)
            pred = ((pred * coef).sum(dim=1, keepdim=True) + 16.0) / 255.0
            target = ((target * coef).sum(dim=1, keepdim=True) + 16.0) / 255.0
        mse = ((pred - target) ** 2).mean(dim=(1, 2, 3))
        return self.loss_weight * self.scale * torch.log(mse + 1e-8).mean()
