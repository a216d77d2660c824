"""Helpers of the degradation-classification models (dcpt_tpu/models/dc_util.py).

Archs return ``taps`` dicts keyed by the reference's module names in forward
order; the models keep the taps whose names contain ``hook_names``, as the
reference's hook registration did (``...pretrain_model.py:64-68``), and feed
them to the classifier reversed.
"""

from __future__ import annotations

import torch


def select_taps(taps: dict, hook_names: str | None) -> list:
    """The features whose tap name contains ``hook_names``, in forward order."""
    if hook_names is None:
        return []
    return [v for k, v in taps.items() if hook_names in k]


def accuracy_topk(logits: torch.Tensor, labels: torch.Tensor, topk=(1,)) -> list[float]:
    """timm-style top-k accuracy in percent (reference: timm.utils.accuracy)."""
    top = logits.topk(max(topk), dim=-1).indices
    correct = top == labels.reshape(-1, 1)
    return [100.0 * correct[:, :k].any(dim=1).float().mean().item() for k in topk]
