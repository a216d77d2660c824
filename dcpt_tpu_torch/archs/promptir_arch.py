"""PromptIR (dcpt_tpu/archs/promptir_arch.py), NCHW, with the reference's module names.

The Restormer U-Net of ``restormer_arch.py`` with softmax attention, WithBias
LayerNorm of eps 1e-5, and learnable prompt banks fused in at three decoder
levels.  Every bias-free ``PromptTransformerBlock`` runs as one call of
``ops.mdta_block.mdta_block_fused`` (kernel K6 on a CUDA tensor, K7 its
backward under autograd), as in ``restormer_arch.py``.

Reference quirks that dcpt_tpu keeps, and so does this port:

* ``noise_level{1,2,3}`` use ``heads[2]`` (reference promptir_arch.py:479);
* ``reduce_noise_level2`` (and level 3) reduce to ``dim * 4``, level 1 to ``dim * 2``;
* ``skip_tail`` (the reference's ``hook=True`` pass) returns right after
  ``reduce_noise_level1``, before ``up2_1``, ``decoder_level1`` and ``refinement``;
* the prompt bank keeps the torch layout (1, len, dim, size, size) and is
  resized bilinearly (no antialias) to the feature size, which on real eval
  images is a non-integer resize.

Levels are plain ``nn.Sequential``: the taps are ``'{level}.{i}'`` after each block.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.registry import ARCH_REGISTRY
from .arch_util import resize_bilinear
from .restormer_arch import ChannelLayerNorm, Downsample, OverlapPatchEmbed, TransformerBlock, Upsample, run_level


class ChannelLayerNorm5(ChannelLayerNorm):
    """Channel LayerNorm with eps 1e-5, WithBias by default (reference promptir_arch.py:26-72)."""

    eps = 1e-5

    def __init__(self, dim: int, bias: bool = True):
        super().__init__(dim, bias)


class PromptTransformerBlock(TransformerBlock):
    """The TransformerBlock with softmax attention and eps-1e-5 LayerNorms."""

    norm_cls = ChannelLayerNorm5

    def __init__(self, dim: int, num_heads: int, ffn_expansion_factor: float = 2.66, bias: bool = False,
                 layernorm_bias: bool = True):
        super().__init__(dim, num_heads, ffn_expansion_factor, bias, layernorm_bias, use_softmax=True)


class PromptGenBlock(nn.Module):
    """A prompt bank weighted by a softmax of a linear map of the input's
    global mean, resized to the input and passed through a 3x3 conv
    (reference promptir_arch.py:238-261)."""

    def __init__(self, prompt_dim: int = 128, prompt_len: int = 5, prompt_size: int = 96, lin_dim: int = 192):
        super().__init__()
        self.prompt_param = nn.Parameter(torch.rand(1, prompt_len, prompt_dim, prompt_size, prompt_size))
        self.linear_layer = nn.Linear(lin_dim, prompt_len)
        self.conv3x3 = nn.Conv2d(prompt_dim, prompt_dim, 3, padding=1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weights = F.softmax(self.linear_layer(x.mean(dim=(2, 3))), dim=1)
        prompt = (weights[:, :, None, None, None] * self.prompt_param).sum(dim=1)
        return self.conv3x3(resize_bilinear(prompt, x.shape[-2:]))


@ARCH_REGISTRY.register()
class PromptIR(nn.Module):
    """PromptIR (reference promptir_arch.py:267-506).

    ``window_size`` is read by the eval harness (reflect-pad to a multiple of
    it); the net itself does not pad.
    """

    def __init__(self, inp_channels: int = 3, out_channels: int = 3, dim: int = 48,
                 num_blocks: Sequence[int] = (4, 6, 6, 8), num_refinement_blocks: int = 4,
                 heads: Sequence[int] = (1, 2, 4, 8), ffn_expansion_factor: float = 2.66, bias: bool = False,
                 LayerNorm_type: str = "WithBias", decoder: bool = True, window_size: int = 8):
        super().__init__()
        ln_bias = LayerNorm_type != "BiasFree"
        self.decoder = decoder

        def block(d: int, h: int) -> nn.Module:
            return PromptTransformerBlock(d, h, ffn_expansion_factor, bias, ln_bias)

        def level(d: int, h: int, n: int) -> nn.Module:
            return nn.Sequential(*[block(d, h) for _ in range(n)])

        self.patch_embed = OverlapPatchEmbed(inp_channels, dim)
        self.encoder_level1 = level(dim, heads[0], num_blocks[0])
        self.down1_2 = Downsample(dim)
        self.encoder_level2 = level(dim * 2, heads[1], num_blocks[1])
        self.down2_3 = Downsample(dim * 2)
        self.encoder_level3 = level(dim * 4, heads[2], num_blocks[2])
        self.down3_4 = Downsample(dim * 4)
        self.latent = level(dim * 8, heads[3], num_blocks[3])
        if decoder:
            # (prompt dim, bank size, width of the features it is fused into, width after the reduce)
            for i, (pdim, size, width, reduce_to) in enumerate(
                    [(64, 64, dim * 2, dim * 2), (128, 32, dim * 4, dim * 4), (320, 16, dim * 8, dim * 4)], start=1):
                setattr(self, f"prompt{i}", PromptGenBlock(pdim, 5, size, width))
                setattr(self, f"noise_level{i}", block(width + pdim, heads[2]))
                setattr(self, f"reduce_noise_level{i}", nn.Conv2d(width + pdim, reduce_to, 1, bias=bias))
        latent_out = dim * 4 if decoder else dim * 8
        self.up4_3 = Upsample(latent_out)
        self.reduce_chan_level3 = nn.Conv2d(latent_out // 2 + dim * 4, dim * 4, 1, bias=bias)
        self.decoder_level3 = level(dim * 4, heads[2], num_blocks[2])
        self.up3_2 = Upsample(dim * 4)
        self.reduce_chan_level2 = nn.Conv2d(dim * 4, dim * 2, 1, bias=bias)
        self.decoder_level2 = level(dim * 2, heads[1], num_blocks[1])
        self.up2_1 = Upsample(dim * 2)
        self.decoder_level1 = level(dim * 2, heads[0], num_blocks[0])
        self.refinement = level(dim * 2, heads[0], num_refinement_blocks)
        self.output = nn.Conv2d(dim * 2, out_channels, 3, padding=1, bias=bias)

    def _prompt_fuse(self, x: torch.Tensor, i: int) -> torch.Tensor:
        """cat(x, prompt{i}(x)) -> noise_level{i} -> reduce_noise_level{i}."""
        x = torch.cat([x, getattr(self, f"prompt{i}")(x)], dim=1)
        return getattr(self, f"reduce_noise_level{i}")(getattr(self, f"noise_level{i}")(x))

    def forward(self, inp_img: torch.Tensor, skip_tail: bool = False):
        """Returns ``(out, taps)``; ``out`` is None when ``skip_tail``."""
        taps: dict[str, torch.Tensor] = {}
        inp_enc1 = self.patch_embed(inp_img.contiguous(memory_format=torch.channels_last))
        out_enc1 = run_level(self.encoder_level1, "encoder_level1", inp_enc1, taps, True)
        out_enc2 = run_level(self.encoder_level2, "encoder_level2", self.down1_2(out_enc1), taps, True)
        out_enc3 = run_level(self.encoder_level3, "encoder_level3", self.down2_3(out_enc2), taps, True)
        latent = run_level(self.latent, "latent", self.down3_4(out_enc3), taps, True)
        if self.decoder:
            latent = self._prompt_fuse(latent, 3)

        x = self.reduce_chan_level3(torch.cat([self.up4_3(latent), out_enc3], dim=1))
        out_dec3 = run_level(self.decoder_level3, "decoder_level3", x, taps, True)
        if self.decoder:
            out_dec3 = self._prompt_fuse(out_dec3, 2)

        x = self.reduce_chan_level2(torch.cat([self.up3_2(out_dec3), out_enc2], dim=1))
        out_dec2 = run_level(self.decoder_level2, "decoder_level2", x, taps, True)
        if self.decoder:
            out_dec2 = self._prompt_fuse(out_dec2, 1)
        if skip_tail:
            return None, taps

        x = torch.cat([self.up2_1(out_dec2), out_enc1], dim=1)
        out_dec1 = run_level(self.decoder_level1, "decoder_level1", x, taps, True)
        out = run_level(self.refinement, "refinement", out_dec1, taps, True)
        return self.output(out) + inp_img, taps
