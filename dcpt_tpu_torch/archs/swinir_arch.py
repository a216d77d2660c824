"""SwinIR (dcpt_tpu/archs/swinir_arch.py), with the reference's module names.

The reference is a modified SwinIR: no relative-position bias and no
shifted-window attention mask, so a shifted block's cyclic shift attends
across the image seam, and the six RSTBs are split into ``encode_layers``
(a ModuleList) and ``decode_layers{i}`` attributes.  Module names are the
reference's (``encode_layers.0.residual_group.blocks.0.attn.qkv.weight``,
``decode_layers2.conv.weight``, ``patch_embed.norm.weight``,
``upsample.0.weight``), so a reference ``.pth`` loads as it is.

The net takes and returns NCHW; its body runs on a (B, H, W, C) map, where
every per-token Linear is a [B*H*W, C] product.  Every SwinTransformerBlock
whose config the kernels take (qkv_bias, no qk_scale, C % heads == 0, fp32 or
bf16, ws * ws <= 64; dcpt_tpu's ``_swin_fused_gate``) runs as one call of
``ops.window_attention.fused_swin_block``: kernel K8 on a CUDA tensor, its
plain version on a CPU one.  With ``DCPT_TPU_SWIN_BLOCK=0`` (read once, at
import, as in dcpt_tpu) the attention branch runs as
``fused_window_attention_ln`` (K10) and the shortcut, LN2 and MLP as the
modules.  Any other config runs the plain modules: the config decides the
route, never a failure.

``forward`` returns ``(out, taps)`` with dcpt_tpu's taps: ``encode_layers.{i}``
and ``decode_layers{i}.residual_group`` after each RSTB, NCHW.  As in
dcpt_tpu, only the denoise head (``upsampler`` "") adds the mean back at the
end; the net does not pad (the eval harness pads to ``window_size``).
"""

from __future__ import annotations

import math
import os
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.naf_block import layer_norm_last
from ..ops.window_attention import fused_swin_block, fused_window_attention_ln, kernel_takes, on_windows
from ..utils.registry import ARCH_REGISTRY

# whole-block kernel K8 by default; "0" routes the attention branch through K10 instead
SWIN_BLOCK_KERNEL = os.environ.get("DCPT_TPU_SWIN_BLOCK", "1") == "1"


def swin_fused_gate(qkv_bias: bool, qk_scale, c: int, heads: int, ws: int, dtype) -> bool:
    """dcpt_tpu's ``_swin_fused_gate``, and what the kernels hold in shared memory."""
    return (qkv_bias and qk_scale is None and c % heads == 0 and dtype in (torch.float32, torch.bfloat16)
            and kernel_takes(c, heads, ws))


class TorchLayerNorm(nn.Module):
    """nn.LayerNorm semantics over the last axis (biased variance, eps 1e-5),
    statistics in fp32, the normalised map back in the input dtype."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm_last(x, self.weight, self.bias, self.eps)


class WindowAttention(nn.Module):
    """W-MSA over (NW, N, C) windows without relative-position bias (reference swinir_arch.py:79-195)."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True, qk_scale: float | None = None):
        super().__init__()
        self.num_heads, self.qk_scale = num_heads, qk_scale
        self.qkv = nn.Linear(dim, dim * 3, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b_, n, c = x.shape
        hd = c // self.num_heads
        qkv = self.qkv(x).reshape(b_, n, 3, self.num_heads, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = torch.softmax((q * (self.qk_scale or hd ** -0.5)) @ k.transpose(-2, -1), dim=-1)
        return self.proj((attn @ v).transpose(1, 2).reshape(b_, n, c))


class SwinMlp(nn.Module):
    """fc1 -> exact-erf GELU -> fc2."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class SwinTransformerBlock(nn.Module):
    """One (S)W-MSA + MLP block over a (B, H, W, C) map (reference swinir_arch.py:210-372)."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 7, shift_size: int = 0, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, qk_scale: float | None = None):
        super().__init__()
        self.num_heads, self.window_size, self.shift_size = num_heads, window_size, shift_size
        self.norm1 = TorchLayerNorm(dim)
        self.attn = WindowAttention(dim, num_heads, qkv_bias, qk_scale)
        self.norm2 = TorchLayerNorm(dim)
        self.mlp = SwinMlp(dim, int(dim * mlp_ratio))

    def op_args(self) -> list[torch.Tensor]:
        """The 12 parameters in ``fused_swin_block``'s layout: Linear weights as (in, out) views."""
        a, m = self.attn, self.mlp
        return [self.norm1.weight, self.norm1.bias, a.qkv.weight.t(), a.qkv.bias, a.proj.weight.t(), a.proj.bias,
                self.norm2.weight, self.norm2.bias, m.fc1.weight.t(), m.fc1.bias, m.fc2.weight.t(), m.fc2.bias]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = x.shape[-1]
        ws, ss, heads = self.window_size, self.shift_size, self.num_heads
        fused = swin_fused_gate(self.attn.qkv.bias is not None, self.attn.qk_scale, c, heads, ws, x.dtype)
        if fused and SWIN_BLOCK_KERNEL:
            return fused_swin_block(x, *self.op_args(), heads, ws, ss, self.norm1.eps)
        if fused:
            a = self.attn
            x = x + fused_window_attention_ln(x, self.norm1.weight, self.norm1.bias, a.qkv.weight.t(), a.qkv.bias,
                                              a.proj.weight.t(), a.proj.bias, heads, ws, ss, self.norm1.eps)
        else:
            x = x + on_windows(self.norm1(x), ws, ss, self.attn)
        return x + self.mlp(self.norm2(x))


class BasicLayer(nn.Module):
    """The RSTB's blocks, under ``blocks`` as in the reference."""

    def __init__(self, blocks: list[nn.Module]):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for blk in self.blocks:
            x = blk(x)
        return x


def _conv3(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1)


class RSTB(nn.Module):
    """Residual Swin Transformer Block (reference swinir_arch.py:545-650): depth
    blocks, a 3x3 conv (or the 3conv bottleneck), the residual around both."""

    def __init__(self, dim: int, input_resolution: tuple[int, int], depth: int, num_heads: int, window_size: int,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True, qk_scale: float | None = None,
                 resi_connection: str = "1conv"):
        super().__init__()
        # the window shrinks with the CONFIGURED resolution, not the runtime shape
        res = min(input_resolution)
        ws = res if res <= window_size else window_size
        self.residual_group = BasicLayer([
            SwinTransformerBlock(dim, num_heads, ws, 0 if (i % 2 == 0 or res <= window_size) else ws // 2,
                                 mlp_ratio, qkv_bias, qk_scale)
            for i in range(depth)])
        if resi_connection == "1conv":
            self.conv = _conv3(dim, dim)
        else:
            self.conv = nn.Sequential(_conv3(dim, dim // 4), nn.LeakyReLU(0.2), nn.Conv2d(dim // 4, dim // 4, 1),
                                      nn.LeakyReLU(0.2), _conv3(dim // 4, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) -> (B, H, W, C)."""
        y = self.residual_group(x).permute(0, 3, 1, 2)
        return self.conv(y).permute(0, 2, 3, 1).contiguous() + x


class PatchEmbed(nn.Module):
    """Holds the patch norm under the reference's name (``patch_embed.norm``)."""

    def __init__(self, dim: int, patch_norm: bool):
        super().__init__()
        self.norm = TorchLayerNorm(dim) if patch_norm else None


@ARCH_REGISTRY.register()
class SwinIR(nn.Module):
    """SwinIR (reference swinir_arch.py:796-1121)."""

    def __init__(self, img_size=128, patch_size: int = 1, in_chans: int = 3, embed_dim: int = 180,
                 depths: Sequence[int] = (6, 6, 6, 6, 6, 6), num_heads: Sequence[int] = (6, 6, 6, 6, 6, 6),
                 window_size: int = 8, mlp_ratio: float = 2.0, qkv_bias: bool = True, qk_scale: float | None = None,
                 ape: bool = False, patch_norm: bool = True, upscale: int = 1, img_range: float = 1.0,
                 upsampler: str = "", resi_connection: str = "1conv"):
        super().__init__()
        img = (img_size, img_size) if isinstance(img_size, int) else tuple(img_size)
        self.patches_resolution = (img[0] // patch_size, img[1] // patch_size)
        self.ape, self.upscale, self.img_range, self.upsampler = ape, upscale, img_range, upsampler
        mean = [0.4488, 0.4371, 0.4040] if in_chans == 3 else [0.0]
        self.register_buffer("mean", torch.tensor(mean).view(1, -1, 1, 1), persistent=False)
        num_feat, half = 64, len(depths) // 2

        self.conv_first = _conv3(in_chans, embed_dim)
        self.patch_embed = PatchEmbed(embed_dim, patch_norm)
        if ape:
            self.absolute_pos_embed = nn.Parameter(
                nn.init.trunc_normal_(torch.zeros(1, math.prod(self.patches_resolution), embed_dim), std=0.02))

        def rstb(i: int) -> RSTB:
            return RSTB(embed_dim, self.patches_resolution, depths[i], num_heads[i], window_size, mlp_ratio,
                        qkv_bias, qk_scale, resi_connection)

        self.encode_layers = nn.ModuleList(rstb(i) for i in range(half))
        self.num_decode = half
        for i in range(half):
            setattr(self, f"decode_layers{i}", rstb(half + i))
        self.norm = TorchLayerNorm(embed_dim)
        self.conv_after_body = _conv3(embed_dim, embed_dim)

        if upsampler == "pixelshuffle":
            self.conv_before_upsample = nn.Sequential(_conv3(embed_dim, num_feat), nn.LeakyReLU(0.01))
            ups = []
            for _ in range(int(math.log2(upscale))):
                ups += [_conv3(num_feat, 4 * num_feat), nn.PixelShuffle(2)]
            self.upsample = nn.Sequential(*ups)
            self.conv_last = _conv3(num_feat, in_chans)
        elif upsampler == "pixelshuffledirect":
            self.upsample = nn.Sequential(_conv3(embed_dim, upscale ** 2 * in_chans), nn.PixelShuffle(upscale))
        elif upsampler == "nearest+conv":
            self.conv_before_upsample = nn.Sequential(_conv3(embed_dim, num_feat), nn.LeakyReLU(0.01))
            self.conv_up1 = _conv3(num_feat, num_feat)
            if upscale == 4:
                self.conv_up2 = _conv3(num_feat, num_feat)
            self.conv_hr = _conv3(num_feat, num_feat)
            self.conv_last = _conv3(num_feat, in_chans)
        else:
            self.conv_last = _conv3(embed_dim, in_chans)

    def forward_features(self, x: torch.Tensor, taps: dict) -> torch.Tensor:
        """NCHW -> the six RSTBs on a (B, H, W, C) map -> norm -> NCHW; fills the taps."""
        f = x.permute(0, 2, 3, 1).contiguous()
        if self.patch_embed.norm is not None:
            f = self.patch_embed.norm(f)
        if self.ape:
            f = f + self.absolute_pos_embed.reshape(1, *self.patches_resolution, -1)
        for i, layer in enumerate(self.encode_layers):
            f = layer(f)
            taps[f"encode_layers.{i}"] = f.permute(0, 3, 1, 2)
        for i in range(self.num_decode):
            f = getattr(self, f"decode_layers{i}")(f)
            taps[f"decode_layers{i}.residual_group"] = f.permute(0, 3, 1, 2)
        return self.norm(f).permute(0, 3, 1, 2)

    def forward(self, x: torch.Tensor, skip_tail: bool = False):
        """Returns ``(out, taps)``; ``out`` is None when ``skip_tail`` (the
        feature-only pass, which stops after the body)."""
        h_in, w_in = x.shape[-2:]
        taps: dict[str, torch.Tensor] = {}
        mean = self.mean.to(x.dtype)
        x = (x - mean) * self.img_range
        if self.upsampler in ("pixelshuffle", "pixelshuffledirect", "nearest+conv"):
            x = self.conv_first(x)
            x = self.conv_after_body(self.forward_features(x, taps)) + x
            if skip_tail:
                return None, taps
            if self.upsampler == "pixelshuffle":
                x = self.conv_last(self.upsample(self.conv_before_upsample(x)))
            elif self.upsampler == "pixelshuffledirect":
                x = self.upsample(x)
            else:
                x = self.conv_before_upsample(x)
                x = F.leaky_relu(self.conv_up1(F.interpolate(x, scale_factor=2, mode="nearest")), 0.2)
                if self.upscale == 4:
                    x = F.leaky_relu(self.conv_up2(F.interpolate(x, scale_factor=2, mode="nearest")), 0.2)
                x = self.conv_last(F.leaky_relu(self.conv_hr(x), 0.2))
        else:
            # denoise / JPEG-CAR residual head (reference swinir_arch.py:1099-1105)
            x_first = self.conv_first(x)
            res = self.conv_after_body(self.forward_features(x_first, taps)) + x_first
            if skip_tail:
                return None, taps
            x = (x + self.conv_last(res)) / self.img_range + mean
        return x[:, :, : h_in * self.upscale, : w_in * self.upscale], taps
