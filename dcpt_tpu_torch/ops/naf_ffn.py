"""NAFBlock FFN half: the hand-written CUDA kernel K5 and its plain version.

Counterpart of ``dcpt_tpu/ops/naf_ffn.py::naf_ffn``: over (..., C),
``y + gamma * (gate(LN(y) @ w4 + b4) @ w5 + b5)`` with gate(h) = h[..., :C] *
h[..., C:] and an LN of fp32 statistics, eps 1e-6.  The op's layouts: w4
(C, 2C) and w5 (C, C) as (in, out); a module passes its PyTorch parameters as
transposed views, which the wrapper transposes back for free.

* ``naf_ffn_ref``: plain PyTorch, dcpt_tpu's ``naf_ffn_ref``.
* ``naf_ffn``: on a CUDA tensor it launches ``csrc/naf_ffn.cu`` (fp32 or bf16
  I/O, fp32 math, the products on the tensor cores, any C up to 8192) or
  raises; on a CPU tensor it returns ``naf_ffn_ref``.  ``naf_ffn.launches`` counts the calls that launched the
  kernel.  Under autograd it runs as ``NAFFFNFunction``: K5 forward, the plain
  version's VJP backward (dcpt_tpu has no backward kernel for it).

``naf_expand`` (K5', dcpt_tpu's ``naf_expand`` ``:131``, ``pallas_call``
``:115``): over (..., c), ``LN(x) @ w1 + b1`` with a WithBias LN (biased
variance, eps 1e-6 by default) and w1 (c, c_out).  ``naf_expand_ref`` follows
dcpt_tpu's ``naf_expand_ref``, its math in x's dtype.  On a CUDA tensor it
launches ``csrc/ln_proj.cu``'s WithBias entry with the output bias (K14's
kernel: one launch, the product on the tensor cores, 3xTF32 in fp32, its LN in
fp32 in both dtypes; w1 contiguous or a transposed view of an (out, in)
weight, neither copied) or raises; on a CPU tensor it returns the plain
version.  ``naf_expand.launches`` counts the calls that launched the
kernel; under autograd ``NAFExpandFunction`` runs the kernel forward and the
plain version's VJP backward, as dcpt_tpu's custom VJP.  dcpt_tpu wires it
into no NAFBlock (``naf_ffn.py:131-141``), and neither does the port.
dcpt_tpu drops to the plain version at c > 512 or c % 16 != 0; the kernel
takes every c and c_out.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import ln_proj
from .cuda_build import load_library
from .naf_block import layer_norm_last


def naf_ffn_ref(y, ln_w, ln_b, w4, b4, w5, b5, gamma, eps: float = 1e-6):
    """The FFN half over (..., C), plain PyTorch."""
    c = y.shape[-1]
    h = layer_norm_last(y, ln_w, ln_b, eps) @ w4 + b4
    return y + gamma * ((h[..., :c] * h[..., c:]) @ w5 + b5)


_ENTRY = {torch.float32: "naf_ffn_f32", torch.bfloat16: "naf_ffn_bf16"}


@functools.cache
def _lib() -> ctypes.CDLL:
    return _bind(load_library("naf_ffn", ["naf_ffn.cu"]))


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points of a build of ``csrc/naf_ffn.cu``."""
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.naf_ffn_scratch_floats.argtypes = [ctypes.c_int] * 2
    lib.naf_ffn_scratch_floats.restype = ctypes.c_longlong
    return lib


def _check(y: torch.Tensor, params: list[torch.Tensor]) -> None:
    if y.dtype not in _ENTRY:
        raise TypeError(f"naf_ffn: the kernel takes float32 or bfloat16, got {y.dtype}")
    c = y.shape[-1]
    if not 1 <= c <= 8192:
        raise ValueError(f"naf_ffn: the kernel takes C in 1..8192, got C={c}")
    shapes = [(c,), (c,), (c, 2 * c), (2 * c,), (c, c), (c,), (c,)]
    for i, (p, shape) in enumerate(zip(params, shapes)):
        if tuple(p.shape) != shape:
            raise ValueError(f"naf_ffn: parameter {i + 1} has shape {tuple(p.shape)}, the kernel takes {shape}")
        if p.device != y.device or p.dtype != y.dtype:
            raise TypeError(f"naf_ffn: parameter {i + 1} is {p.dtype} on {p.device}, y is {y.dtype} on {y.device}")


def _launch(lib, y, params, eps: float, stream: int) -> torch.Tensor:
    """Allocate the output and the fp32 scratch and run the kernel's C entry on ``stream``."""
    c = y.shape[-1]
    y2 = y.contiguous().view(-1, c)
    ln_w, ln_b, w4, b4, w5, b5, gamma = params
    weights = [t.contiguous() for t in (ln_w, ln_b, w4.t(), b4, w5.t(), b5, gamma)]
    part = torch.empty(lib.naf_ffn_scratch_floats(y2.shape[0], c), dtype=torch.float32, device=y.device)
    z = torch.empty_like(y2)
    err = getattr(lib, _ENTRY[y.dtype])(y2.data_ptr(), *(t.data_ptr() for t in weights), part.data_ptr(),
                                        z.data_ptr(), y2.shape[0], c, eps, stream)
    if err != 0:
        raise RuntimeError(f"naf_ffn kernel launch failed with CUDA error {err}")
    return z.view(y.shape)


def _forward(y, params, eps: float) -> torch.Tensor:
    if y.device.type == "cpu":
        return naf_ffn_ref(y, *params, eps)
    _check(y, params)
    naf_ffn.launches += 1
    with torch.cuda.device(y.device):
        return _launch(_lib(), y, params, eps, torch.cuda.current_stream().cuda_stream)


class NAFFFNFunction(torch.autograd.Function):
    """``apply(y, eps, ln_w, ln_b, w4, b4, w5, b5, gamma)``: K5 forward (its plain
    version on the CPU), the VJP of ``naf_ffn_ref`` backward, as dcpt_tpu's
    custom VJP."""

    @staticmethod
    def forward(ctx, y, eps, *params):
        ctx.eps = eps
        ctx.save_for_backward(y, *params)
        return _forward(y, list(params), eps)

    @staticmethod
    def backward(ctx, dz):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = naf_ffn_ref(*inputs, ctx.eps)
        grads = torch.autograd.grad(out, inputs, dz)
        return (grads[0], None, *grads[1:])


def naf_ffn(y, ln_w, ln_b, w4, b4, w5, b5, gamma, eps: float = 1e-6) -> torch.Tensor:
    """The fused FFN half over (..., C): K5 on a CUDA tensor, the plain version on a CPU tensor."""
    params = [ln_w, ln_b, w4, b4, w5, b5, gamma]
    if y.device.type not in ("cpu", "cuda"):
        raise ValueError(f"naf_ffn: no kernel for device {y.device}")
    if torch.is_grad_enabled() and (y.requires_grad or any(p.requires_grad for p in params)):
        return NAFFFNFunction.apply(y, eps, *params)
    return _forward(y, params, eps)


naf_ffn.launches = 0


def naf_expand_ref(x, ln_w, ln_b, w1, b1, eps: float = 1e-6):
    """LN(x) @ w1 + b1 over (..., c), plain PyTorch, the math in x's dtype (dcpt_tpu's naf_expand_ref)."""
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return ((x - mu) * torch.rsqrt(var + eps) * ln_w + ln_b) @ w1 + b1


def _expand_forward(x, ln_w, ln_b, w1, b1, eps: float) -> torch.Tensor:
    if x.device.type == "cpu":
        return naf_expand_ref(x, ln_w, ln_b, w1, b1, eps)
    c, c_out = x.shape[-1], w1.shape[-1]
    ln_proj.check("naf_expand", x, [ln_w, ln_b, w1, b1], [(c,), (c,), (c, c_out), (c_out,)])
    naf_expand.launches += 1
    entry = ln_proj._entry("naf_expand", x.dtype)
    return ln_proj.on_device(x, lambda stream: ln_proj.launch(None, x, ln_w, ln_b, w1, eps, stream, bias=b1,
                                                              entry=entry))


class NAFExpandFunction(torch.autograd.Function):
    """``apply(x, ln_w, ln_b, w1, b1, eps)``: the kernel forward (its plain version
    on the CPU), the VJP of ``naf_expand_ref`` backward."""

    @staticmethod
    def forward(ctx, x, ln_w, ln_b, w1, b1, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, ln_w, ln_b, w1, b1)
        return _expand_forward(x, ln_w, ln_b, w1, b1, eps)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = naf_expand_ref(*inputs, ctx.eps)
        return (*torch.autograd.grad(out, inputs, g), None)


def naf_expand(x, ln_w, ln_b, w1, b1, eps: float = 1e-6) -> torch.Tensor:
    """LN -> 1x1 expand over (..., c) with w1 (c, c_out): the kernel on a CUDA
    tensor, the plain version on a CPU tensor."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"naf_expand: no kernel for device {x.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, ln_w, ln_b, w1, b1)):
        return NAFExpandFunction.apply(x, ln_w, ln_b, w1, b1, eps)
    return _expand_forward(x, ln_w, ln_b, w1, b1, eps)


naf_expand.launches = 0
