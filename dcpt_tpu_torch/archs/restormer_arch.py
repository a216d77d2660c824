"""Restormer and Restormer_origin (dcpt_tpu/archs/restormer_arch.py), NCHW, with the reference's module names.

Every TransformerBlock whose convs are bias-free (both shipped configs) runs as
one call of ``ops.mdta_block.mdta_block_fused``: the hand-written CUDA kernel
K6 on a CUDA tensor (fp32 or bf16), its plain version on a CPU tensor; under
autograd its backward is kernel K7 (fp32).  A
config with ``bias: true`` runs the plain modules (``MDTA``, ``GDFN``), as
dcpt_tpu does (its gate, ``restormer_arch.py:264-265``); the config decides,
never a failure.  The blocks take their input as ``torch.channels_last``, so
the (B, H, W, C) view the op takes is free.

Semantics kept from dcpt_tpu: ReLU attention in this repo's Restormer variant
(``use_softmax`` False), BiasFree LayerNorm with centred variance and
uncentred output, eps 1e-6 for both LayerNorm types, exact-erf GELU, GDFN
convs bias-free whatever ``bias`` says, Downsample = 3x3 conv (C -> C/2) +
pixel-unshuffle, Upsample = 3x3 conv (C -> 2C) + pixel-shuffle.

Parameter names are the reference's (``encoder_level1.body.0.norm1.body.weight``,
``attn.temperature`` of shape (heads, 1, 1), ``down1_2.body.0.weight``,
``patch_embed.proj.weight``, ``output.{i}`` for the SR heads), so a reference
``.pth`` loads as it is.  ``forward`` returns ``(out, taps)`` with dcpt_tpu's
taps: ``'{level}.body'`` after each level for ``Restormer``, ``'{level}.{i}'``
after each block for ``Restormer_origin``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.mdta_block import mdta_block_fused
from ..utils.registry import ARCH_REGISTRY


class _NormParams(nn.Module):
    """The reference LayerNorm's ``body``: weight, and bias for WithBias."""

    def __init__(self, dim: int, bias: bool):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim)) if bias else None


class ChannelLayerNorm(nn.Module):
    """LayerNorm over the channel axis of an NCHW map (reference restormer_arch.py:26-72),
    statistics in fp32, the normalised map back in the input dtype, then the affine."""

    eps = 1e-6

    def __init__(self, dim: int, bias: bool = False):
        super().__init__()
        self.with_bias = bias
        self.body = _NormParams(dim, bias)

    def affine(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(weight, bias) in the op's layout; BiasFree's bias is zero (dcpt_tpu's _NormParamHolder)."""
        w = self.body.weight
        return w, self.body.bias if self.with_bias else torch.zeros_like(w)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.permute(0, 2, 3, 1).float()
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        if self.with_bias:
            out = ((xf - mu) * torch.rsqrt(var + self.eps)).to(x.dtype) * self.body.weight + self.body.bias
        else:
            out = (xf * torch.rsqrt(var + self.eps)).to(x.dtype) * self.body.weight
        return out.permute(0, 3, 1, 2)


class MDTA(nn.Module):
    """Multi-Dconv-head transposed attention over channels (reference restormer_arch.py:103-145),
    the plain modules that a ``bias: true`` config runs."""

    def __init__(self, dim: int, num_heads: int, bias: bool = False, use_softmax: bool = False):
        super().__init__()
        self.num_heads, self.use_softmax = num_heads, use_softmax
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.qkv = nn.Conv2d(dim, dim * 3, 1, bias=bias)
        self.qkv_dwconv = nn.Conv2d(dim * 3, dim * 3, 3, padding=1, groups=dim * 3, bias=bias)
        self.project_out = nn.Conv2d(dim, dim, 1, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        q, k, v = (t.reshape(b, self.num_heads, c // self.num_heads, h * w)
                   for t in self.qkv_dwconv(self.qkv(x)).chunk(3, dim=1))
        attn = (F.normalize(q, dim=-1) @ F.normalize(k, dim=-1).transpose(-2, -1)) * self.temperature
        attn = attn.softmax(dim=-1) if self.use_softmax else F.relu(attn)
        return self.project_out((attn @ v).reshape(b, c, h, w))


class GDFN(nn.Module):
    """Gated-dconv feed-forward network (reference restormer_arch.py:75-100); its
    convs are bias-free whatever ``bias`` says, as in dcpt_tpu."""

    def __init__(self, dim: int, ffn_expansion_factor: float = 2.66, bias: bool = False):
        super().__init__()
        hidden = int(dim * ffn_expansion_factor)
        self.hidden = hidden
        self.project_in = nn.Conv2d(dim, hidden * 2, 1, bias=False)
        self.dwconv = nn.Conv2d(hidden * 2, hidden * 2, 3, padding=1, groups=hidden * 2, bias=False)
        self.project_out = nn.Conv2d(hidden, dim, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1, x2 = self.dwconv(self.project_in(x)).chunk(2, dim=1)
        return self.project_out(F.gelu(x1) * x2)


class TransformerBlock(nn.Module):
    """norm1 -> MDTA -> +, norm2 -> GDFN -> + (reference restormer_arch.py:148-165)."""

    norm_cls = ChannelLayerNorm

    def __init__(self, dim: int, num_heads: int, ffn_expansion_factor: float = 2.66, bias: bool = False,
                 layernorm_bias: bool = False, use_softmax: bool = False):
        super().__init__()
        self.norm1 = self.norm_cls(dim, layernorm_bias)
        self.attn = MDTA(dim, num_heads, bias, use_softmax)
        self.norm2 = self.norm_cls(dim, layernorm_bias)
        self.ffn = GDFN(dim, ffn_expansion_factor, bias)
        self.use_kernel = not bias

    def op_args(self) -> list[torch.Tensor]:
        """The parameters in ``mdta_block_fused``'s layout, as views (no copies)."""
        c, f = self.attn.project_out.weight.shape[0], self.ffn.hidden
        return [*self.norm1.affine(),
                self.attn.qkv.weight.view(3 * c, c).t(), self.attn.qkv_dwconv.weight.view(3 * c, 3, 3).permute(1, 2, 0),
                self.attn.temperature, self.attn.project_out.weight.view(c, c).t(),
                *self.norm2.affine(),
                self.ffn.project_in.weight.view(2 * f, c).t(), self.ffn.dwconv.weight.view(2 * f, 3, 3).permute(1, 2, 0),
                self.ffn.project_out.weight.view(c, f).t()]

    def forward(self, inp: torch.Tensor) -> torch.Tensor:
        if self.use_kernel:
            x = inp.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
            z = mdta_block_fused(x, *self.op_args(), self.attn.num_heads, self.attn.use_softmax, self.norm1.with_bias,
                                 self.norm1.eps)
            return z.permute(0, 3, 1, 2)
        x = inp + self.attn(self.norm1(inp))
        return x + self.ffn(self.norm2(x))


class SequentialTransformerBlock(nn.Module):
    """This repo's hookable level: its blocks under ``body`` (reference restormer_arch.py:235-245)."""

    def __init__(self, blocks: list[nn.Module]):
        super().__init__()
        self.body = nn.Sequential(*blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.body(x)


class OverlapPatchEmbed(nn.Module):
    def __init__(self, in_c: int, embed_dim: int):
        super().__init__()
        self.proj = nn.Conv2d(in_c, embed_dim, 3, padding=1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x)


class Downsample(nn.Module):
    def __init__(self, n_feat: int):
        super().__init__()
        self.body = nn.Sequential(nn.Conv2d(n_feat, n_feat // 2, 3, padding=1, bias=False), nn.PixelUnshuffle(2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.body(x)


class Upsample(nn.Module):
    def __init__(self, n_feat: int):
        super().__init__()
        self.body = nn.Sequential(nn.Conv2d(n_feat, n_feat * 2, 3, padding=1, bias=False), nn.PixelShuffle(2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.body(x)


def run_level(level: nn.Module, name: str, x: torch.Tensor, taps: dict, per_block: bool) -> torch.Tensor:
    """Run a level's blocks; tap each block as ``'{name}.{i}'`` (``per_block``)
    or the level as ``'{name}.body'``."""
    if not per_block:
        x = level(x)
        taps[f"{name}.body"] = x
        return x
    for i, blk in enumerate(level):
        x = blk(x)
        taps[f"{name}.{i}"] = x
    return x


class _RestormerBody(nn.Module):
    """The 4-level U-Net shared by Restormer and Restormer_origin (reference restormer_arch.py:248-422).

    ``window_size`` is read by the eval harness (reflect-pad to a multiple of
    it); the net itself does not pad.
    """

    per_block_taps = False

    def __init__(self, inp_channels: int = 3, out_channels: int = 3, dim: int = 48,
                 num_blocks: Sequence[int] = (4, 6, 6, 8), num_refinement_blocks: int = 4,
                 heads: Sequence[int] = (1, 2, 4, 8), ffn_expansion_factor: float = 2.66, bias: bool = False,
                 LayerNorm_type: str = "BiasFree", dual_pixel_task: bool = False, scale: int = 1,
                 window_size: int = 8, use_softmax: bool = False):
        super().__init__()
        ln_bias = LayerNorm_type != "BiasFree"
        self.scale, self.dual_pixel_task = scale, dual_pixel_task

        def level(d: int, h: int, n: int) -> nn.Module:
            blocks = [TransformerBlock(d, h, ffn_expansion_factor, bias, ln_bias, use_softmax) for _ in range(n)]
            return nn.Sequential(*blocks) if self.per_block_taps else SequentialTransformerBlock(blocks)

        self.patch_embed = OverlapPatchEmbed(inp_channels, dim)
        self.encoder_level1 = level(dim, heads[0], num_blocks[0])
        self.down1_2 = Downsample(dim)
        self.encoder_level2 = level(dim * 2, heads[1], num_blocks[1])
        self.down2_3 = Downsample(dim * 2)
        self.encoder_level3 = level(dim * 4, heads[2], num_blocks[2])
        self.down3_4 = Downsample(dim * 4)
        self.latent = level(dim * 8, heads[3], num_blocks[3])
        self.up4_3 = Upsample(dim * 8)
        self.reduce_chan_level3 = nn.Conv2d(dim * 8, dim * 4, 1, bias=bias)
        self.decoder_level3 = level(dim * 4, heads[2], num_blocks[2])
        self.up3_2 = Upsample(dim * 4)
        self.reduce_chan_level2 = nn.Conv2d(dim * 4, dim * 2, 1, bias=bias)
        self.decoder_level2 = level(dim * 2, heads[1], num_blocks[1])
        self.up2_1 = Upsample(dim * 2)
        self.decoder_level1 = level(dim * 2, heads[0], num_blocks[0])
        self.refinement = level(dim * 2, heads[0], num_refinement_blocks)
        if scale == 1:
            if dual_pixel_task:
                self.skip_conv = nn.Conv2d(dim, dim * 2, 1, bias=bias)
            self.output = nn.Conv2d(dim * 2, out_channels, 3, padding=1, bias=bias)
        else:
            # SR heads (reference restormer_arch.py:344-367,415-420): 2^scale conv
            # heads whose outputs interleave through a pixel shuffle
            self.output = nn.ModuleList(nn.Conv2d(dim * 2, out_channels, 3, padding=1, bias=bias)
                                        for _ in range(2 ** scale))

    def forward(self, inp_img: torch.Tensor, skip_tail: bool = False):
        """Returns ``(out, taps)``; ``out`` is None when ``skip_tail`` (the
        reference's ``hook=True`` feature-only pass, which stops after decoder_level1)."""
        taps: dict[str, torch.Tensor] = {}
        per_block = self.per_block_taps
        inp_enc1 = self.patch_embed(inp_img.contiguous(memory_format=torch.channels_last))
        out_enc1 = run_level(self.encoder_level1, "encoder_level1", inp_enc1, taps, per_block)
        out_enc2 = run_level(self.encoder_level2, "encoder_level2", self.down1_2(out_enc1), taps, per_block)
        out_enc3 = run_level(self.encoder_level3, "encoder_level3", self.down2_3(out_enc2), taps, per_block)
        latent = run_level(self.latent, "latent", self.down3_4(out_enc3), taps, per_block)

        x = self.reduce_chan_level3(torch.cat([self.up4_3(latent), out_enc3], dim=1))
        out_dec3 = run_level(self.decoder_level3, "decoder_level3", x, taps, per_block)
        x = self.reduce_chan_level2(torch.cat([self.up3_2(out_dec3), out_enc2], dim=1))
        out_dec2 = run_level(self.decoder_level2, "decoder_level2", x, taps, per_block)
        x = torch.cat([self.up2_1(out_dec2), out_enc1], dim=1)
        out_dec1 = run_level(self.decoder_level1, "decoder_level1", x, taps, per_block)
        if skip_tail:
            return None, taps

        out = run_level(self.refinement, "refinement", out_dec1, taps, per_block)
        if self.scale != 1:
            return F.pixel_shuffle(torch.cat([head(out) + inp_img for head in self.output], dim=1), self.scale), taps
        if self.dual_pixel_task:
            return self.output(out + self.skip_conv(inp_enc1)), taps
        return self.output(out) + inp_img, taps


@ARCH_REGISTRY.register()
class Restormer(_RestormerBody):
    """This repo's DCPT variant: ReLU attention, BiasFree LN by default, levels
    wrapped in ``SequentialTransformerBlock`` (reference restormer_arch.py:235-422)."""


@ARCH_REGISTRY.register()
class Restormer_origin(_RestormerBody):
    """Upstream-layout Restormer (reference restormer_arch.py:426-518): WithBias
    LN by default, plain ``nn.Sequential`` levels tapped per block, the same
    ReLU-attention block."""

    per_block_taps = True

    def __init__(self, *args, LayerNorm_type: str = "WithBias", **kwargs):
        super().__init__(*args, LayerNorm_type=LayerNorm_type, **kwargs)
