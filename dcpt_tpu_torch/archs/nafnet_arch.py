"""NAFNet (dcpt_tpu/archs/nafnet_arch.py), NCHW, with the reference's module names.

Every NAFBlock runs as one call of ``ops.naf_block.naf_block_fused``: the
hand-written CUDA kernel on a CUDA tensor (fp32 or bf16), the plain twin on a
CPU tensor.  The blocks take their input as ``torch.channels_last`` so the
(B, H, W, C) view the op takes is free.

The U-Net keeps the reference's parameter names (``encoders.0.0.conv1.weight``,
``...sca.1.weight``, ``beta`` of shape (1, C, 1, 1), ``decoder{i}.{j}``), so a
reference ``.pth`` loads without a converter, and ``forward`` returns
``(out, taps)`` with the taps dcpt_tpu returns: the outputs of the modules
whose names have one dot (``encoders.{i}``, ``downs.{i}``, ``middle_blks.{j}``,
``ups.{i}``, ``decoder{i}.{j}``).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops.naf_block import naf_block_fused
from ..utils.registry import ARCH_REGISTRY
from .arch_util import LayerNorm2d


class NAFBlock(nn.Module):
    """LN -> 1x1 expand -> depthwise 3x3 -> SimpleGate -> SCA -> 1x1, then the gated
    FFN, with residual scales beta and gamma (reference: nafnet_arch.py:83-186)."""

    def __init__(self, c: int):
        super().__init__()
        dw = ffn = 2 * c
        self.c, self.dw, self.ffn = c, dw, ffn
        self.conv1 = nn.Conv2d(c, dw, 1)
        self.conv2 = nn.Conv2d(dw, dw, 3, padding=1, groups=dw)
        self.conv3 = nn.Conv2d(dw // 2, c, 1)
        self.sca = nn.Sequential(nn.AdaptiveAvgPool2d(1), nn.Conv2d(dw // 2, dw // 2, 1))
        self.conv4 = nn.Conv2d(c, ffn, 1)
        self.conv5 = nn.Conv2d(ffn // 2, c, 1)
        self.norm1 = LayerNorm2d(c)
        self.norm2 = LayerNorm2d(c)
        self.beta = nn.Parameter(torch.zeros((1, c, 1, 1)))
        self.gamma = nn.Parameter(torch.zeros((1, c, 1, 1)))

    def op_args(self) -> list[torch.Tensor]:
        """The parameters in ``naf_block_fused``'s layout, as views (no copies)."""
        c, dw, ffn = self.c, self.dw, self.ffn
        return [self.norm1.weight, self.norm1.bias,
                self.conv1.weight.view(dw, c).t(), self.conv1.bias,
                self.conv2.weight.view(dw, 3, 3).permute(1, 2, 0), self.conv2.bias,
                self.sca[1].weight.view(dw // 2, dw // 2).t(), self.sca[1].bias,
                self.conv3.weight.view(c, dw // 2).t(), self.conv3.bias,
                self.beta.view(c), self.norm2.weight, self.norm2.bias,
                self.conv4.weight.view(ffn, c).t(), self.conv4.bias,
                self.conv5.weight.view(c, ffn // 2).t(), self.conv5.bias, self.gamma.view(c)]

    def forward(self, inp: torch.Tensor) -> torch.Tensor:
        x = inp.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
        return naf_block_fused(x, *self.op_args(), self.norm1.eps).permute(0, 3, 1, 2)


@ARCH_REGISTRY.register()
class NAFNetBaseline(nn.Module):
    """U-Net of NAFBlocks (reference: nafnet_arch.py:190-274).

    ``window_size`` is read by the eval harness (reflect-pad to a multiple of
    it); the net itself does not pad.
    """

    def __init__(self, img_channel: int = 3, width: int = 16, middle_blk_num: int = 1,
                 enc_blk_nums: Sequence[int] = (), dec_blk_nums: Sequence[int] = (), window_size: int = 8):
        super().__init__()
        self.intro = nn.Conv2d(img_channel, width, 3, padding=1)
        self.ending = nn.Conv2d(width, img_channel, 3, padding=1)
        self.encoders = nn.ModuleList()
        self.downs = nn.ModuleList()
        self.ups = nn.ModuleList()
        chan = width
        for num in enc_blk_nums:
            self.encoders.append(nn.Sequential(*[NAFBlock(chan) for _ in range(num)]))
            self.downs.append(nn.Conv2d(chan, 2 * chan, 2, 2))
            chan *= 2
        self.middle_blks = nn.Sequential(*[NAFBlock(chan) for _ in range(middle_blk_num)])
        for i, num in enumerate(dec_blk_nums):
            self.ups.append(nn.Sequential(nn.Conv2d(chan, chan * 2, 1, bias=False), nn.PixelShuffle(2)))
            chan //= 2
            setattr(self, f"decoder{i}", nn.Sequential(*[NAFBlock(chan) for _ in range(num)]))

    def forward(self, inp: torch.Tensor, skip_tail: bool = False):
        """Returns ``(out, taps)``; ``out`` is None when ``skip_tail`` (the
        reference's ``hook=True`` feature-only pass)."""
        taps: dict[str, torch.Tensor] = {}
        x = self.intro(inp.contiguous(memory_format=torch.channels_last))
        encs = []
        for i, (encoder, down) in enumerate(zip(self.encoders, self.downs)):
            x = encoder(x)
            taps[f"encoders.{i}"] = x
            encs.append(x)
            x = down(x)
            taps[f"downs.{i}"] = x
        for j, blk in enumerate(self.middle_blks):
            x = blk(x)
            taps[f"middle_blks.{j}"] = x
        for i, up in enumerate(self.ups):
            x = up(x)
            taps[f"ups.{i}"] = x
            x = x + encs[-(i + 1)]
            for j, blk in enumerate(getattr(self, f"decoder{i}")):
                x = blk(x)
                taps[f"decoder{i}.{j}"] = x
        if skip_tail:
            return None, taps
        return self.ending(x) + inp, taps
