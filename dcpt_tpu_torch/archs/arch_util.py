"""Shared arch building blocks (dcpt_tpu/archs/arch_util.py), NCHW.

Parameters keep PyTorch's default initialisation, which is the reference's:
``nn.Conv2d``'s kaiming-uniform(a=sqrt(5)) weights with fan-in uniform biases,
and LayerNorm2d's weight 1 / bias 0.  dcpt_tpu's ``pixel_shuffle`` and
``pixel_unshuffle`` are PyTorch's own (``F.pixel_shuffle``, ``nn.PixelShuffle``
and their inverses give the reference's channel order).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.layernorm2d import layer_norm_2d
from ..ops.naf_block import layer_norm_last


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of an NCHW map, half-pixel centres, no antialias: what
    dcpt_tpu's ``jax.image.resize(..., antialias=False)`` computes (its
    ``arch_util.py:239-261``)."""
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear", align_corners=False)


class LayerNorm2d(nn.Module):
    """LayerNorm over the channel axis of an NCHW map (reference: nafnet_arch.py:25-64).

    At dcpt_tpu's gate, C % 128 == 0 and C >= 512 (its ``arch_util.py:111``),
    the norm runs through ``ops.layernorm2d.layer_norm_2d``: kernel K3 on a CUDA
    tensor, its plain version on a CPU one.  Below the gate it is plain PyTorch
    with fp32 statistics.  A ``channels_last`` input makes the (B, H, W, C)
    view free."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.use_kernel = channels % 128 == 0 and channels >= 512

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 2, 3, 1)
        if self.use_kernel:
            return layer_norm_2d(x, self.weight, self.bias, self.eps).permute(0, 3, 1, 2)
        return layer_norm_last(x, self.weight, self.bias, self.eps).permute(0, 3, 1, 2)
