"""NAFBlock attention-branch prefix: the hand-written CUDA kernel K4 and its plain version.

Counterpart of ``dcpt_tpu/ops/naf_prefix.py::naf_prefix``: on (B, H, W, C),
LN (fp32 statistics, eps 1e-6) -> 1x1 C -> DW (+b1) -> depthwise 3x3 with
zero padding (+bdw) -> SimpleGate, giving (B, H, W, DW/2).  The op's layouts:
w1 (C, DW) as (in, out), wdw (3, 3, DW).  A module passes its PyTorch
parameters as transposed views; the wrapper transposes them back, which costs
nothing for such views.

* ``naf_prefix_ref``: plain PyTorch, dcpt_tpu's ``naf_prefix_ref`` without its
  ``DCPT_TPU_DW_DENSE`` A/B lever.
* ``naf_prefix``: on a CUDA tensor it launches ``csrc/naf_prefix.cu`` (fp32 or
  bf16 I/O, fp32 math, the expand on the tensor cores, DW = 2C, any C up to
  8192) or raises; on a CPU tensor it returns ``naf_prefix_ref``.  ``naf_prefix.launches`` counts the calls that
  launched the kernel.  Under autograd it runs as ``NAFPrefixFunction``: K4
  forward, the plain version's VJP backward (dcpt_tpu has no backward kernel
  for it).  dcpt_tpu runs its kernel only where the whole map fits its VMEM
  budget (``prefix_fits``); K4 takes any H x W.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .cuda_build import load_library
from .naf_block import layer_norm_last


def naf_prefix_ref(x, ln_w, ln_b, w1, b1, wdw, bdw, eps: float = 1e-6):
    """LN -> 1x1 (C -> DW) -> depthwise 3x3 -> gate on (B, H, W, C), plain PyTorch."""
    dw = w1.shape[1]
    t = layer_norm_last(x, ln_w, ln_b, eps) @ w1 + b1
    t = F.conv2d(t.permute(0, 3, 1, 2), wdw.permute(2, 0, 1).unsqueeze(1), bdw, padding=1, groups=dw)
    t = t.permute(0, 2, 3, 1)
    return t[..., : dw // 2] * t[..., dw // 2:]


_ENTRY = {torch.float32: "naf_prefix_f32", torch.bfloat16: "naf_prefix_bf16"}


@functools.cache
def _lib() -> ctypes.CDLL:
    return _bind(load_library("naf_prefix", ["naf_prefix.cu"]))


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points of a build of ``csrc/naf_prefix.cu``."""
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.naf_prefix_scratch_floats.argtypes = [ctypes.c_int] * 4
    lib.naf_prefix_scratch_floats.restype = ctypes.c_longlong
    return lib


def _check(x: torch.Tensor, params: list[torch.Tensor]) -> None:
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"naf_prefix: x must be a contiguous (B, H, W, C) tensor, got {tuple(x.shape)} "
                         f"with strides {x.stride()}")
    if x.dtype not in _ENTRY:
        raise TypeError(f"naf_prefix: the kernel takes float32 or bfloat16, got {x.dtype}")
    c = x.shape[3]
    if not 1 <= c <= 8192:
        raise ValueError(f"naf_prefix: the kernel takes C in 1..8192, got C={c}")
    shapes = [(c,), (c,), (c, 2 * c), (2 * c,), (3, 3, 2 * c), (2 * c,)]
    for i, (p, shape) in enumerate(zip(params, shapes)):
        if tuple(p.shape) != shape:
            raise ValueError(f"naf_prefix: parameter {i + 1} has shape {tuple(p.shape)}, the kernel takes {shape} "
                             f"(DW = 2C)")
        if p.device != x.device or p.dtype != x.dtype:
            raise TypeError(f"naf_prefix: parameter {i + 1} is {p.dtype} on {p.device}, x is {x.dtype} on {x.device}")


def _launch(lib, x, params, eps: float, stream: int) -> torch.Tensor:
    """Allocate the output and the fp32 scratch and run the kernel's C entry on ``stream``."""
    b, h, w, c = x.shape
    ln_w, ln_b, w1, b1, wdw, bdw = params
    weights = [t.contiguous() for t in (ln_w, ln_b, w1.t(), b1, wdw.permute(2, 0, 1), bdw)]
    g = torch.empty_like(x)
    part = torch.empty(lib.naf_prefix_scratch_floats(b, h, w, c), dtype=torch.float32, device=x.device)
    err = getattr(lib, _ENTRY[x.dtype])(x.data_ptr(), *(t.data_ptr() for t in weights), g.data_ptr(),
                                        part.data_ptr(), b, h, w, c, eps, stream)
    if err != 0:
        raise RuntimeError(f"naf_prefix kernel launch failed with CUDA error {err}")
    return g


def _forward(x, params, eps: float) -> torch.Tensor:
    if x.device.type == "cpu":
        return naf_prefix_ref(x, *params, eps)
    _check(x, params)
    naf_prefix.launches += 1
    with torch.cuda.device(x.device):
        return _launch(_lib(), x, params, eps, torch.cuda.current_stream().cuda_stream)


class NAFPrefixFunction(torch.autograd.Function):
    """``apply(x, eps, ln_w, ln_b, w1, b1, wdw, bdw)``: K4 forward (its plain
    version on the CPU), the VJP of ``naf_prefix_ref`` backward, as dcpt_tpu's
    custom VJP."""

    @staticmethod
    def forward(ctx, x, eps, *params):
        ctx.eps = eps
        ctx.save_for_backward(x, *params)
        return _forward(x, list(params), eps)

    @staticmethod
    def backward(ctx, dg):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = naf_prefix_ref(*inputs, ctx.eps)
        grads = torch.autograd.grad(out, inputs, dg)
        return (grads[0], None, *grads[1:])


def naf_prefix(x, ln_w, ln_b, w1, b1, wdw, bdw, eps: float = 1e-6) -> torch.Tensor:
    """The fused prefix over (B, H, W, C): K4 on a CUDA tensor, the plain version on a CPU tensor."""
    params = [ln_w, ln_b, w1, b1, wdw, bdw]
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"naf_prefix: no kernel for device {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or any(p.requires_grad for p in params)):
        return NAFPrefixFunction.apply(x, eps, *params)
    return _forward(x, params, eps)


naf_prefix.launches = 0
