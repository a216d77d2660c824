"""Helpers of the degradation-classification models (dcpt_tpu/models/dc_util.py).

Archs return ``taps`` dicts keyed by the reference's module names in forward
order; the models keep the taps whose names contain ``hook_names``, as the
reference's hook registration did (``...pretrain_model.py:64-68``), and feed
them to the classifier reversed.  DCDistModel's Restormer_origin filter keeps
only each encoder level's last block (``select_taps_restormer_origin``).
"""

from __future__ import annotations

import re

import torch


def select_taps(taps: dict, hook_names: str | None) -> list:
    """The features whose tap name contains ``hook_names``, in forward order."""
    if hook_names is None:
        return []
    return [v for k, v in taps.items() if hook_names in k]


_LEVEL_IDX = re.compile(r"^(\w+?)(\d)\.(\d+)$")


def select_taps_restormer_origin(taps: dict, hook_names: str | None) -> list:
    """DCDistModel's hard-coded Restormer_origin selection (reference
    ``...distillation_model.py:88-93``): of the taps whose name contains
    ``hook_names``, the last block of each encoder level, block 5 of levels 2
    and 3 and block 3 of level 1, in forward order."""
    out = []
    for k, v in taps.items():
        if hook_names is None or hook_names not in k:
            continue
        m = _LEVEL_IDX.match(k)
        if m and (int(m.group(3)), int(m.group(2))) in ((5, 2), (5, 3), (3, 1)):
            out.append(v)
    return out


def accuracy_topk(logits: torch.Tensor, labels: torch.Tensor, topk=(1,)) -> list[float]:
    """timm-style top-k accuracy in percent (reference: timm.utils.accuracy)."""
    top = logits.topk(max(topk), dim=-1).indices
    correct = top == labels.reshape(-1, 1)
    return [100.0 * correct[:, :k].any(dim=1).float().mean().item() for k in topk]
