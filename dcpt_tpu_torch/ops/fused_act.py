"""Fused bias + LeakyReLU + scale (StyleGAN2's fused_act): the hand-written CUDA kernel K12 and its plain version.

Counterpart of ``dcpt_tpu/ops/fused_act.py::fused_bias_leaky_relu`` (``:78``;
``pallas_call`` ``:42`` forward, ``:64`` backward): over a channels-last
(..., C) x and a bias (C,), ``out = scale · leaky_relu(x + bias, slope)``,
with the int8 mask ``x + bias > 0`` kept for the backward
``gx = scale · where(mask, g, slope · g)`` and ``gb = Σ gx`` over the rows.

* ``fused_bias_leaky_relu_ref`` / ``fused_bias_leaky_relu_bwd_ref``: plain
  PyTorch (forward with its mask; gx from g and the mask).
* ``fused_bias_leaky_relu``: on a CUDA tensor the kernels of
  ``csrc/fused_act.cu`` (fp32 or bf16, the output in x's dtype) or it raises;
  on a CPU tensor the plain versions.  Under autograd it runs as
  ``FusedBiasLeakyReLUFunction``: the forward kernel writes out and the mask,
  the backward kernel gx; ``gb`` is ``torch.sum`` of gx over the rows, as
  dcpt_tpu leaves it to XLA.  ``.launches`` and ``.bwd_launches`` count the
  calls that launched the forward and the backward kernel.

The mask is strict, so at ``x + bias == 0`` the gradient is ``slope · scale``.
Every value is rounded to the I/O type after each operation, kernel and plain
version alike, so the two agree bit for bit in both dtypes.  dcpt_tpu tiles
the rows by a power of two that divides them; every row count and C is taken
here.  Bound on the H100: bytes (forward 2·n·itemsize + n for the mask,
backward the same), over 3.35 TB/s.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .cuda_build import load_library


def fused_bias_leaky_relu_ref(x, bias, negative_slope: float = 0.2, scale: float = 2 ** 0.5):
    """(out, mask) in plain PyTorch: out in x's dtype, mask int8 ``x + bias > 0``."""
    v = x + bias
    pos = v > 0
    return torch.where(pos, v, v * negative_slope) * scale, pos.to(torch.int8)


def fused_bias_leaky_relu_bwd_ref(g, mask, negative_slope: float = 0.2, scale: float = 2 ** 0.5):
    """gx from the cotangent and the forward's mask, plain PyTorch."""
    return torch.where(mask > 0, g, g * negative_slope) * scale


_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


@functools.cache
def _lib() -> ctypes.CDLL:
    return _bind(load_library("fused_act", ["fused_act.cu"]))


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points of a build of ``csrc/fused_act.cu``."""
    for suffix in _SUFFIX.values():
        fwd, bwd = getattr(lib, "fused_act_fwd_" + suffix), getattr(lib, "fused_act_bwd_" + suffix)
        fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_float,
                                                ctypes.c_void_p]
        bwd.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
        fwd.restype = bwd.restype = ctypes.c_int
    return lib


def _check(x, bias) -> None:
    if x.dtype not in _SUFFIX:
        raise TypeError(f"fused_bias_leaky_relu: the kernel takes float32 or bfloat16, got {x.dtype}")
    if bias.dtype != x.dtype or bias.device != x.device:
        raise TypeError(f"fused_bias_leaky_relu: bias is {bias.dtype} on {bias.device}, x is {x.dtype} on {x.device}")
    if x.dim() < 1 or tuple(bias.shape) != (x.shape[-1],):
        raise ValueError(f"fused_bias_leaky_relu: bias must be ({x.shape[-1] if x.dim() else '?'},), got "
                         f"{tuple(bias.shape)}")


def _launch_fwd(lib, x, bias, slope: float, scale: float, stream: int):
    """(out, mask) of x (..., C) on ``stream``."""
    xc = x.contiguous()
    out = torch.empty_like(xc)
    mask = torch.empty(xc.shape, dtype=torch.int8, device=x.device)
    err = getattr(lib, "fused_act_fwd_" + _SUFFIX[x.dtype])(xc.data_ptr(), bias.contiguous().data_ptr(),
                                                           out.data_ptr(), mask.data_ptr(), xc.numel(),
                                                           x.shape[-1], slope, scale, stream)
    if err != 0:
        raise RuntimeError(f"fused_bias_leaky_relu forward kernel launch failed with CUDA error {err}")
    return out, mask


def _launch_bwd(lib, g, mask, slope: float, scale: float, stream: int):
    """gx from g and the forward's mask on ``stream``."""
    gc = g.contiguous()
    gx = torch.empty_like(gc)
    err = getattr(lib, "fused_act_bwd_" + _SUFFIX[g.dtype])(gc.data_ptr(), mask.data_ptr(), gx.data_ptr(),
                                                           gc.numel(), slope, scale, stream)
    if err != 0:
        raise RuntimeError(f"fused_bias_leaky_relu backward kernel launch failed with CUDA error {err}")
    return gx


def _forward(x, bias, slope: float, scale: float):
    if x.device.type == "cpu":
        return fused_bias_leaky_relu_ref(x, bias, slope, scale)
    _check(x, bias)
    fused_bias_leaky_relu.launches += 1
    with torch.cuda.device(x.device):
        return _launch_fwd(_lib(), x, bias, slope, scale, torch.cuda.current_stream().cuda_stream)


class FusedBiasLeakyReLUFunction(torch.autograd.Function):
    """``apply(x, bias, negative_slope, scale)``: K12's forward keeping the int8
    mask and its backward kernel for gx (the plain versions on a CPU tensor);
    gb is the sum of gx over the rows."""

    @staticmethod
    def forward(ctx, x, bias, negative_slope, scale):
        out, mask = _forward(x, bias, negative_slope, scale)
        ctx.save_for_backward(mask)
        ctx.slope, ctx.scale, ctx.bias_dtype = negative_slope, scale, bias.dtype
        return out

    @staticmethod
    def backward(ctx, g):
        (mask,) = ctx.saved_tensors
        if g.device.type == "cpu":
            gx = fused_bias_leaky_relu_bwd_ref(g, mask, ctx.slope, ctx.scale)
        else:
            if g.dtype not in _SUFFIX:
                raise TypeError(f"fused_bias_leaky_relu backward: the kernel takes float32 or bfloat16, got {g.dtype}")
            fused_bias_leaky_relu.bwd_launches += 1
            with torch.cuda.device(g.device):
                gx = _launch_bwd(_lib(), g, mask, ctx.slope, ctx.scale, torch.cuda.current_stream().cuda_stream)
        gb = gx.reshape(-1, gx.shape[-1]).sum(0).to(ctx.bias_dtype) if ctx.needs_input_grad[1] else None
        return gx, gb, None, None


def fused_bias_leaky_relu(x: torch.Tensor, bias: torch.Tensor, negative_slope: float = 0.2,
                          scale: float = 2 ** 0.5) -> torch.Tensor:
    """``scale · leaky_relu(x + bias)`` over (..., C): K12 on a CUDA tensor, the plain version on a CPU tensor."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_bias_leaky_relu: no kernel for device {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or bias.requires_grad):
        return FusedBiasLeakyReLUFunction.apply(x, bias, negative_slope, scale)
    return _forward(x, bias, negative_slope, scale)[0]


fused_bias_leaky_relu.launches = 0
fused_bias_leaky_relu.bwd_launches = 0
