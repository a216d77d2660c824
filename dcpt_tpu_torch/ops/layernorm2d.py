"""Channel LayerNorm over (..., C): the hand-written CUDA kernel K3 and its plain version.

Counterpart of ``dcpt_tpu/ops/layernorm2d.py::layer_norm_2d``:
``out = (x - mean) / sqrt(var + eps) * weight + bias`` over the last axis,
biased variance, with the analytic backward
``gx = rsigma * (g*w - y * mean(g*w*y) - mean(g*w))``, ``gw = sum g*y``,
``gb = sum g``.

* ``layer_norm_2d_ref`` / ``layer_norm_2d_bwd_ref``: plain PyTorch.
* ``layer_norm_2d``: on a CUDA tensor the kernels of ``csrc/layernorm2d.cu``
  (fp32 or bf16 I/O, fp32 statistics), or it raises; on a CPU tensor the plain
  versions.  In bf16 the residuals y and 1/sigma stay fp32 and the weight
  gradients are summed in fp32, each cast once to its primal's dtype.  Under autograd it
  runs as ``LayerNorm2dFunction``, whose forward saves y and 1/sigma; without
  a gradient the forward writes only the output, as dcpt_tpu's primal call.
  ``layer_norm_2d.launches`` and ``layer_norm_2d.bwd_launches`` count the
  calls that launched the forward and the backward kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .cuda_build import load_library


def _wide(t: torch.Tensor) -> torch.Tensor:
    """t in fp32, or as it is when already fp32 or wider."""
    return t if t.dtype in (torch.float32, torch.float64) else t.float()


def layer_norm_2d_ref(x: torch.Tensor, weight, bias, eps: float = 1e-6):
    """(out, y, rsigma) of the LayerNorm over the last axis, plain PyTorch: the
    math in fp32 (or wider), out in x's dtype, y and rsigma in fp32 (or wider)."""
    xf = _wide(x)
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    rsig = torch.rsqrt(var + eps)
    y = (xf - mu) * rsig
    return (y * _wide(weight) + _wide(bias)).to(x.dtype), y, rsig


def layer_norm_2d_bwd_ref(g: torch.Tensor, y, rsig, weight):
    """(gx, gw, gb) from the forward's y and rsigma, plain PyTorch: the math in
    fp32 (or wider), gx in g's dtype, gw and gb in weight's."""
    gf = _wide(g)
    gw_ = gf * _wide(weight)
    gx = rsig * (gw_ - y * (gw_ * y).mean(-1, keepdim=True) - gw_.mean(-1, keepdim=True))
    dims = tuple(range(g.dim() - 1))
    return gx.to(g.dtype), (gf * y).sum(dims).to(weight.dtype), gf.sum(dims).to(weight.dtype)


_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


@functools.cache
def _lib() -> ctypes.CDLL:
    return _bind(load_library("layernorm2d", ["layernorm2d.cu"]))


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points of a build of ``csrc/layernorm2d.cu``."""
    for suffix in _SUFFIX.values():
        fwd, bwd = getattr(lib, "ln_fwd_" + suffix), getattr(lib, "ln_bwd_" + suffix)
        fwd.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_void_p]
        bwd.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        fwd.restype = bwd.restype = ctypes.c_int
    lib.ln_bwd_workspace_floats.argtypes = [ctypes.c_int] * 2
    lib.ln_bwd_workspace_floats.restype = ctypes.c_longlong
    return lib


def _check(x, weight, bias) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm_2d: no kernel for device {x.device}")
    c = x.shape[-1]
    if x.dtype not in _SUFFIX:
        raise TypeError(f"layer_norm_2d: the kernel takes float32 or bfloat16, got {x.dtype}")
    for name, t in (("weight", weight), ("bias", bias)):
        if t.dtype != x.dtype or t.device != x.device:
            raise TypeError(f"layer_norm_2d: {name} is {t.dtype} on {t.device}, x is {x.dtype} on {x.device}")
    if tuple(weight.shape) != (c,) or tuple(bias.shape) != (c,):
        raise ValueError(f"layer_norm_2d: weight and bias must be ({c},), got {tuple(weight.shape)}, {tuple(bias.shape)}")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _launch_fwd(lib, x, weight, bias, eps: float, stream: int, residuals: bool):
    """out, or (out, y, rsig) with ``residuals``; x (..., C)."""
    c = x.shape[-1]
    x2 = x.contiguous().view(-1, c)
    out = torch.empty_like(x2)
    y = torch.empty(x2.shape, dtype=torch.float32, device=x.device) if residuals else None
    rsig = torch.empty(x2.shape[0], dtype=torch.float32, device=x.device) if residuals else None
    fwd = getattr(lib, "ln_fwd_" + _SUFFIX[x.dtype])
    err = fwd(x2.data_ptr(), weight.contiguous().data_ptr(), bias.contiguous().data_ptr(), out.data_ptr(),
              y.data_ptr() if residuals else None, rsig.data_ptr() if residuals else None, x2.shape[0], c, eps, stream)
    if err != 0:
        raise RuntimeError(f"layer_norm_2d forward kernel launch failed with CUDA error {err}")
    out = out.view(x.shape)
    return (out, y, rsig) if residuals else out


def _launch_bwd(lib, g, y, rsig, weight, stream: int):
    """(gx, gw, gb) in weight's dtype; g (..., C), y (rows, C) and rsig (rows,) fp32."""
    c = g.shape[-1]
    g2 = g.to(weight.dtype).contiguous().view(-1, c)
    rows = g2.shape[0]
    gx = torch.empty_like(g2)
    gw = torch.empty(c, dtype=weight.dtype, device=g.device)
    gb = torch.empty_like(gw)
    ws = torch.empty(lib.ln_bwd_workspace_floats(rows, c), dtype=torch.float32, device=g.device)
    bwd = getattr(lib, "ln_bwd_" + _SUFFIX[weight.dtype])
    err = bwd(g2.data_ptr(), y.data_ptr(), rsig.data_ptr(), weight.contiguous().data_ptr(), gx.data_ptr(),
              gw.data_ptr(), gb.data_ptr(), ws.data_ptr(), rows, c, stream)
    if err != 0:
        raise RuntimeError(f"layer_norm_2d backward kernel launch failed with CUDA error {err}")
    return gx.view(g.shape), gw, gb


class LayerNorm2dFunction(torch.autograd.Function):
    """``apply(x, weight, bias, eps)``: K3's forward saving y and 1/sigma, and its
    analytic backward; the plain versions on a CPU tensor."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        if x.device.type == "cpu":
            out, y, rsig = layer_norm_2d_ref(x, weight, bias, eps)
        else:
            _check(x, weight, bias)
            layer_norm_2d.launches += 1
            with torch.cuda.device(x.device):
                out, y, rsig = _launch_fwd(_lib(), x, weight, bias, eps, _stream(), residuals=True)
        ctx.save_for_backward(y, rsig, weight)
        return out

    @staticmethod
    def backward(ctx, g):
        y, rsig, weight = ctx.saved_tensors
        if g.device.type == "cpu":
            gx, gw, gb = layer_norm_2d_bwd_ref(g, y, rsig, weight)
        else:
            layer_norm_2d.bwd_launches += 1
            with torch.cuda.device(g.device):
                gx, gw, gb = _launch_bwd(_lib(), g, y, rsig, weight, _stream())
        return gx, gw, gb, None


def layer_norm_2d(x: torch.Tensor, weight, bias, eps: float = 1e-6) -> torch.Tensor:
    """Channel LayerNorm over the last axis of x: K3 on a CUDA tensor, plain on a CPU tensor."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"layer_norm_2d: no kernel for device {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad or bias.requires_grad):
        return LayerNorm2dFunction.apply(x, weight, bias, eps)
    if x.device.type == "cpu":
        return layer_norm_2d_ref(x, weight, bias, eps)[0]
    _check(x, weight, bias)
    layer_norm_2d.launches += 1
    with torch.cuda.device(x.device):
        return _launch_fwd(_lib(), x, weight, bias, eps, _stream(), residuals=False)


layer_norm_2d.launches = 0
layer_norm_2d.bwd_launches = 0
