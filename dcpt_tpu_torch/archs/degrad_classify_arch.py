"""Degradation classifiers (dcpt_tpu/archs/degrad_classify_arch.py), NCHW.

The DCPT probe (reference ``basicsr/archs/degrad_classify_arch.py:481-641``): a
Detectron2-style bottleneck ResNet whose stages fuse the restoration net's
tapped features through softmax mixing weights, ending in global average
pooling and an ``fc`` over the degradation classes.

* ``PromptIR_DC``: with a 7x7 / 2 conv stem on the LQ image;
* ``PromptIR_NoImg_DC``: from the features alone.

Keys are the reference's (``bottleneck_layers.{i}.{b}.conv1.norm.weight``,
``downsample_layers.{l}.0.weight``, ``last_stage.{b}``, ``conv_embed.{0,1}``,
``fc``, ``mixing_weights``).  Convolutions keep the Caffe2 MSRA fill (kaiming
normal, fan_out).  The convs and ``fc`` are PyTorch's own products, as in
dcpt_tpu they are XLA's; the LayerNorms of 512 channels and more run through
kernel K3 (``archs/arch_util.py``).  Maps stay ``channels_last`` so the norms'
(B, H, W, C) views are free.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.registry import ARCH_REGISTRY
from .arch_util import LayerNorm2d


class ConvNorm(nn.Conv2d):
    """Conv2d without bias, then a LayerNorm2d as its ``norm`` (Detectron2's Conv2d)."""

    def __init__(self, in_ch: int, out_ch: int, k: int, stride: int = 1):
        super().__init__(in_ch, out_ch, k, stride=stride, padding=k // 2, bias=False)
        self.norm = LayerNorm2d(out_ch)
        nn.init.kaiming_normal_(self.weight, mode="fan_out", nonlinearity="relu")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(super().forward(x))


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck with a LayerNorm after each conv (reference :132-243)."""

    def __init__(self, in_channels: int, out_channels: int, bottleneck_channels: int, stride: int = 1):
        super().__init__()
        self.conv1 = ConvNorm(in_channels, bottleneck_channels, 1)
        self.conv2 = ConvNorm(bottleneck_channels, bottleneck_channels, 3, stride)
        self.conv3 = ConvNorm(bottleneck_channels, out_channels, 1)
        self.shortcut = ConvNorm(in_channels, out_channels, 1, stride) if in_channels != out_channels else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv3(F.relu(self.conv2(F.relu(self.conv1(x)))))
        return F.relu(out + (self.shortcut(x) if self.shortcut is not None else x))


class _DCBase(nn.Module):
    def __init__(self, feature_dims: Sequence[int], num_res_blocks: int, num_classes: int):
        super().__init__()
        dims = list(feature_dims)
        self.feature_dims = dims
        self.bottleneck_layers = nn.ModuleList(
            nn.Sequential(*[BottleneckBlock(d, d, 2 * d) for _ in range(num_res_blocks)]) for d in dims)
        self.downsample_layers = nn.ModuleList()
        for level, d in enumerate(dims):
            out_dim = dims[level + 1] if level < len(dims) - 1 else d
            conv = nn.Conv2d(d, out_dim, 1, bias=False)
            nn.init.kaiming_normal_(conv.weight, mode="fan_out", nonlinearity="relu")
            self.downsample_layers.append(nn.Sequential(conv, nn.MaxPool2d(2), nn.ReLU()))
        self.last_stage = nn.Sequential(*[BottleneckBlock(dims[-1], dims[-1], 2 * dims[-1])
                                          for _ in range(num_res_blocks)])
        self.mixing_weights = nn.Parameter(torch.ones(len(dims)))
        self.fc = nn.Linear(dims[-1], num_classes)

    def _classify(self, x, features) -> torch.Tensor:
        mixing = torch.softmax(self.mixing_weights, dim=0)
        for i, feature in enumerate(features):
            x = self.bottleneck_layers[i](x + mixing[i] * feature)
            x = self.downsample_layers[i](x)
        x = self.last_stage(x)
        return self.fc(x.mean(dim=(2, 3)))


@ARCH_REGISTRY.register()
class PromptIR_DC(_DCBase):
    """Classifier with an LQ-image conv stem (reference :481-555)."""

    def __init__(self, feature_dims: Sequence[int] = (64, 128, 256, 512), num_res_blocks: int = 2,
                 num_classes: int = 3):
        super().__init__(feature_dims, num_res_blocks, num_classes)
        self.conv_embed = nn.Sequential(nn.Conv2d(3, self.feature_dims[0], 7, stride=2, padding=3),
                                        LayerNorm2d(self.feature_dims[0]))

    def forward(self, lq: torch.Tensor, features: Sequence[torch.Tensor]) -> torch.Tensor:
        x = self.conv_embed(lq.contiguous(memory_format=torch.channels_last))
        return self._classify(x, features)


@ARCH_REGISTRY.register()
class PromptIR_NoImg_DC(_DCBase):
    """Classifier from the features alone (reference :559-641).  With
    ``downsample``, (B, N, C) token features become square maps and level i
    shrinks by 1 / 2^i (nearest, half-pixel centres as ``jax.image.resize``)."""

    def __init__(self, feature_dims: Sequence[int] = (64, 128, 256, 512), num_res_blocks: int = 2,
                 num_classes: int = 3, downsample: bool = False):
        super().__init__(feature_dims, num_res_blocks, num_classes)
        self.downsample = downsample

    def forward(self, lq: torch.Tensor, features: Sequence[torch.Tensor]) -> torch.Tensor:
        features = list(features)
        if self.downsample:
            for i, f in enumerate(features):
                if f.dim() == 3:
                    b, n, c = f.shape
                    s = int(math.sqrt(n))
                    features[i] = f.reshape(b, s, s, c).permute(0, 3, 1, 2)
            for i in range(1, len(features)):
                h, w = features[i].shape[-2:]
                features[i] = F.interpolate(features[i], size=(h // 2**i, w // 2**i), mode="nearest-exact")
        return self._classify(0.0, features)
