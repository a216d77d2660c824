"""NAFBlock FFN half: the hand-written CUDA kernel K5 and its plain version.

Counterpart of ``dcpt_tpu/ops/naf_ffn.py::naf_ffn``: over (..., C),
``y + gamma * (gate(LN(y) @ w4 + b4) @ w5 + b5)`` with gate(h) = h[..., :C] *
h[..., C:] and an LN of fp32 statistics, eps 1e-6.  The op's layouts: w4
(C, 2C) and w5 (C, C) as (in, out); a module passes its PyTorch parameters as
transposed views, which the wrapper transposes back for free.

* ``naf_ffn_ref``: plain PyTorch, dcpt_tpu's ``naf_ffn_ref``.
* ``naf_ffn``: on a CUDA tensor it launches ``csrc/naf_ffn.cu`` (fp32 or bf16
  I/O, fp32 math, C a multiple of 64) or raises; on a CPU tensor it returns
  ``naf_ffn_ref``.  ``naf_ffn.launches`` counts the calls that launched the
  kernel.  Under autograd it runs as ``NAFFFNFunction``: K5 forward, the plain
  version's VJP backward (dcpt_tpu has no backward kernel for it).

dcpt_tpu's ``naf_expand`` (LN -> 1x1, the same file) has no call site there
and is not ported yet (ROADMAP Q2).
"""

from __future__ import annotations

import ctypes
import functools

import torch

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
    return lib


def _check(y: torch.Tensor, params: list[torch.Tensor]) -> None:
    if y.dtype not in _ENTRY:
        raise TypeError(f"naf_ffn: the kernel takes float32 or bfloat16, got {y.dtype}")
    c = y.shape[-1]
    if c % 64 or not 64 <= c <= 8192:
        raise ValueError(f"naf_ffn: the kernel takes C in 64..8192 in steps of 64, got C={c}")
    shapes = [(c,), (c,), (c, 2 * c), (2 * c,), (c, c), (c,), (c,)]
    for i, (p, shape) in enumerate(zip(params, shapes)):
        if tuple(p.shape) != shape:
            raise ValueError(f"naf_ffn: parameter {i + 1} has shape {tuple(p.shape)}, the kernel takes {shape}")
        if p.device != y.device or p.dtype != y.dtype:
            raise TypeError(f"naf_ffn: parameter {i + 1} is {p.dtype} on {p.device}, y is {y.dtype} on {y.device}")


def _launch(lib, y, params, eps: float, stream: int) -> torch.Tensor:
    """Allocate the output and the hidden map and run the kernel's C entry on ``stream``."""
    c = y.shape[-1]
    y2 = y.contiguous().view(-1, c)
    ln_w, ln_b, w4, b4, w5, b5, gamma = params
    weights = [t.contiguous() for t in (ln_w, ln_b, w4.t(), b4, w5.t(), b5, gamma)]
    hidden = torch.empty(y2.shape, dtype=torch.float32, device=y.device)
    z = torch.empty_like(y2)
    err = getattr(lib, _ENTRY[y.dtype])(y2.data_ptr(), *(t.data_ptr() for t in weights), hidden.data_ptr(),
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
