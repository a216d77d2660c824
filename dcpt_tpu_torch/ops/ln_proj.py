"""Channel LayerNorm fused with a 1x1 projection: the hand-written CUDA kernel K14 and its plain version.

Counterpart of ``dcpt_tpu/ops/ln_proj.py::fused_ln_proj`` (``:75``,
``pallas_call`` ``:60``): over (..., c), ``LN(x) @ w`` with w (c, c_out), the
LayerNorm's statistics in fp32 with the centred variance, BiasFree
(``(x·rs)·ln_w``, uncentred output) or WithBias (``((x−μ)·rs)·ln_w + ln_b``).
It is the prefix of MDTA's qkv and GDFN's project_in when those modules are
called with ``pre_norm`` (``archs/restormer_arch.py``).

* ``ln_proj_ref``: plain PyTorch, dcpt_tpu's ``ln_proj_ref``: the normalised
  value is cast to x's dtype before the LayerNorm weight, as there (in bf16
  that rounding shows).
* ``fused_ln_proj``: on a CUDA tensor it launches ``csrc/ln_proj.cu`` (fp32
  or bf16 I/O, fp32 math, every c and c_out) or raises; on a CPU tensor it
  returns ``ln_proj_ref``.  ``fused_ln_proj.launches`` counts the calls that
  launched the kernel.  Under autograd it runs as ``LNProjFunction``: the
  kernel forward, the plain version's VJP backward, as dcpt_tpu's custom VJP
  differentiates ``ln_proj_ref``.

dcpt_tpu drops to ``ln_proj_ref`` at c > 512, c % 16 != 0 or a weight over
6 MB (VMEM limits of the TPU); the kernel takes every shape.  Bound on the
H100: 2·c·c_out flops a row against (c + c_out) itemsize bytes, operations
at all but the narrowest Restormer widths (``csrc/ln_proj.cu``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .cuda_build import load_library


def ln_proj_ref(x, ln_w, ln_b, w, eps: float = 1e-6, biasfree: bool = False):
    """LN(x) @ w over (..., c) -> (..., c_out), plain PyTorch; ln_b is unread when biasfree."""
    xf = x if x.dtype in (torch.float32, torch.float64) else x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    rs = torch.rsqrt(var + eps)
    ln = (xf * rs).to(x.dtype) * ln_w if biasfree else ((xf - mu) * rs).to(x.dtype) * ln_w + ln_b
    return ln @ w


_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


@functools.cache
def _lib() -> ctypes.CDLL:
    return _bind(load_library("ln_proj", ["ln_proj.cu"]))


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points of a build of ``csrc/ln_proj.cu`` (K14, and naf_expand's)."""
    for suffix in _SUFFIX.values():
        proj, expand = getattr(lib, "ln_proj_" + suffix), getattr(lib, "naf_expand_" + suffix)
        proj.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        expand.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]
        proj.restype = expand.restype = ctypes.c_int
    return lib


def check(name: str, x: torch.Tensor, params: list[torch.Tensor], shapes: list[tuple]) -> None:
    """Raise unless x is fp32 or bf16 and each parameter has its shape, x's dtype and device."""
    if x.dtype not in _SUFFIX:
        raise TypeError(f"{name}: the kernel takes float32 or bfloat16, got {x.dtype}")
    if x.dim() < 1:
        raise ValueError(f"{name}: x must be (..., c)")
    for i, (p, shape) in enumerate(zip(params, shapes)):
        if tuple(p.shape) != shape:
            raise ValueError(f"{name}: parameter {i + 1} has shape {tuple(p.shape)}, the kernel takes {shape}")
        if p.device != x.device or p.dtype != x.dtype:
            raise TypeError(f"{name}: parameter {i + 1} is {p.dtype} on {p.device}, x is {x.dtype} on {x.device}")


def launch(lib, x, ln_w, ln_b, w, eps: float, stream: int, biasfree: bool = False, bias=None) -> torch.Tensor:
    """LN(x) @ w (+ bias) on ``stream``: ``fused_ln_proj``'s entry, or with
    ``bias`` naf_expand's (WithBias, its LN in fp32); x (..., c), w (c, c_out)."""
    c, c_out = w.shape
    x2 = x.contiguous().view(-1, c)
    out = torch.empty(x2.shape[0], c_out, dtype=x.dtype, device=x.device)
    args = [x2.data_ptr(), ln_w.contiguous().data_ptr(), ln_b.contiguous().data_ptr(), w.contiguous().data_ptr()]
    if bias is None:
        err = getattr(lib, "ln_proj_" + _SUFFIX[x.dtype])(*args, out.data_ptr(), x2.shape[0], c, c_out, eps,
                                                         int(not biasfree), stream)
    else:
        err = getattr(lib, "naf_expand_" + _SUFFIX[x.dtype])(*args, bias.contiguous().data_ptr(), out.data_ptr(),
                                                            x2.shape[0], c, c_out, eps, stream)
    if err != 0:
        raise RuntimeError(f"{'ln_proj' if bias is None else 'naf_expand'} kernel launch failed with CUDA error {err}")
    return out.view(*x.shape[:-1], c_out)


def _forward(x, ln_w, ln_b, w, eps: float, biasfree: bool) -> torch.Tensor:
    if x.device.type == "cpu":
        return ln_proj_ref(x, ln_w, ln_b, w, eps, biasfree)
    c = x.shape[-1]
    check("fused_ln_proj", x, [ln_w, ln_b, w], [(c,), (c,), (c, w.shape[-1])])
    fused_ln_proj.launches += 1
    with torch.cuda.device(x.device):
        return launch(_lib(), x, ln_w, ln_b, w, eps, torch.cuda.current_stream().cuda_stream, biasfree=biasfree)


class LNProjFunction(torch.autograd.Function):
    """``apply(x, ln_w, ln_b, w, eps, biasfree)``: K14 forward (its plain version
    on the CPU), the VJP of ``ln_proj_ref`` backward."""

    @staticmethod
    def forward(ctx, x, ln_w, ln_b, w, eps, biasfree):
        ctx.eps, ctx.biasfree = eps, biasfree
        ctx.save_for_backward(x, ln_w, ln_b, w)
        return _forward(x, ln_w, ln_b, w, eps, biasfree)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = ln_proj_ref(*inputs, ctx.eps, ctx.biasfree)
        return (*torch.autograd.grad(out, inputs, g, allow_unused=True), None, None)


def fused_ln_proj(x: torch.Tensor, ln_w, ln_b, w, eps: float = 1e-6, biasfree: bool = False) -> torch.Tensor:
    """LN(x) @ w over (..., c) with w (c, c_out): K14 on a CUDA tensor, the plain
    version on a CPU tensor; pass ln_b = zeros for BiasFree, as dcpt_tpu does."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_ln_proj: no kernel for device {x.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, ln_w, ln_b, w)):
        return LNProjFunction.apply(x, ln_w, ln_b, w, eps, biasfree)
    return _forward(x, ln_w, ln_b, w, eps, biasfree)


fused_ln_proj.launches = 0
