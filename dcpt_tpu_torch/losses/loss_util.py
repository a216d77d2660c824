"""Loss reduction helpers (dcpt_tpu/losses/loss_util.py), NCHW: the weight's channel axis is 1."""

from __future__ import annotations

import functools

import torch


def reduce_loss(loss: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "none":
        return loss
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    raise ValueError(f"invalid reduction: {reduction}")


def weight_reduce_loss(loss: torch.Tensor, weight=None, reduction: str = "mean") -> torch.Tensor:
    """Elementwise weight, then the reduction (reference: loss_util.py:27-56).  'mean'
    with a weight divides by the weight's mass; a one-channel weight counts once per channel."""
    if weight is not None:
        if weight.dim() != loss.dim() or weight.shape[1] not in (1, loss.shape[1]):
            raise ValueError(f"weight {tuple(weight.shape)} does not fit loss {tuple(loss.shape)}")
        loss = loss * weight
    if weight is None or reduction == "sum":
        return reduce_loss(loss, reduction)
    if reduction == "mean":
        denom = weight.sum() if weight.shape[1] > 1 else weight.sum() * loss.shape[1]
        return loss.sum() / denom
    return loss


def weighted_loss(loss_func):
    """Add ``weight`` and ``reduction`` arguments to an elementwise loss."""

    @functools.wraps(loss_func)
    def wrapper(pred, target, weight=None, reduction="mean", **kwargs):
        return weight_reduce_loss(loss_func(pred, target, **kwargs), weight, reduction)

    return wrapper
