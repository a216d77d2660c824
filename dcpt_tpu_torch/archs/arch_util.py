"""Shared arch building blocks (dcpt_tpu/archs/arch_util.py), NCHW.

Parameters keep PyTorch's default initialisation, which is the reference's:
``nn.Conv2d``'s kaiming-uniform(a=sqrt(5)) weights with fan-in uniform biases,
and LayerNorm2d's weight 1 / bias 0.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.naf_block import layer_norm_last


class LayerNorm2d(nn.Module):
    """LayerNorm over the channel axis of an NCHW map (reference: nafnet_arch.py:25-64)."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm_last(x.permute(0, 2, 3, 1), self.weight, self.bias, self.eps).permute(0, 3, 1, 2)
