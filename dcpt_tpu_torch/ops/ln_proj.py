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

The kernel runs its product on the tensor cores (``mma.sync`` TF32, 3xTF32
for fp32 operands, through ``csrc/tc_gemm.cuh``'s pieces), one launch a
call, the LayerNorm applied in registers as each staged pair of x is read
into an MMA fragment.  It reads w (c, c_out) in either layout without a
copy: contiguous (dcpt_tpu's (in, out)), or a transposed view of PyTorch's
(out, in) 1x1 weight such as ``_ln_conv1x1`` passes
(``archs/restormer_arch.py``); a weight with other strides is copied.

dcpt_tpu drops to ``ln_proj_ref`` at c > 512, c % 16 != 0 or a weight over
6 MB (VMEM limits of the TPU); the kernel takes every shape.  Bound on the
H100: 2·c·c_out flops a row against (c + c_out) itemsize bytes: at
Restormer's first level (c 48) the bytes it writes, elsewhere operations
(``csrc/ln_proj.cu``).
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
        weight = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int]  # x, ln_w, ln_b, w, its ld, k-major
        proj.argtypes = weight + [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_float] + [ctypes.c_int] * 2 \
            + [ctypes.c_void_p]
        expand.argtypes = weight + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int,
                                                                                 ctypes.c_void_p]
        proj.restype = expand.restype = ctypes.c_int
    lib.ln_proj_tile.argtypes, lib.ln_proj_tile.restype = [ctypes.c_int] * 4, ctypes.c_int
    return lib


@functools.cache
def _entry(name: str, dtype: torch.dtype):
    """The ctypes function ``name``_f32 or _bf16 of the nvcc build, resolved once."""
    return getattr(_lib(), f"{name}_{_SUFFIX[dtype]}")


def check(name: str, x: torch.Tensor, params: list[torch.Tensor], shapes: list[tuple]) -> None:
    """Raise unless x is fp32 or bf16 and each parameter has its shape, x's dtype and device."""
    dtype, device = x.dtype, x.device
    if dtype not in _SUFFIX:
        raise TypeError(f"{name}: the kernel takes float32 or bfloat16, got {dtype}")
    if x.dim() < 1:
        raise ValueError(f"{name}: x must be (..., c)")
    for i, (p, shape) in enumerate(zip(params, shapes)):
        if p.shape != shape:
            raise ValueError(f"{name}: parameter {i + 1} has shape {tuple(p.shape)}, the kernel takes {shape}")
        if p.dtype != dtype or p.device != device:
            raise TypeError(f"{name}: parameter {i + 1} is {p.dtype} on {p.device}, x is {dtype} on {device}")


def _dense(t: torch.Tensor) -> torch.Tensor:
    return t if t.is_contiguous() else t.contiguous()


def weight_layout(w: torch.Tensor) -> tuple[torch.Tensor, int, int]:
    """(w, ld, k_major) of w (c, c_out) as the kernel reads it: contiguous, element
    (k, n) at k·c_out + n (k_major 0); a transposed view of a contiguous (c_out,
    c) weight, at n·c + k (k_major 1); any other strides, a contiguous copy."""
    c, c_out = w.shape
    if w.is_contiguous():
        return w, c_out, 0
    if w.stride() == (1, c):  # both sizes over 1 here: is_contiguous took the others
        return w, c, 1
    return w.contiguous(), c_out, 0


def launch(lib, x, ln_w, ln_b, w, eps: float, stream: int, biasfree: bool = False, bias=None, entry=None,
           tile: int = -1) -> torch.Tensor:
    """LN(x) @ w (+ bias) on ``stream``: ``fused_ln_proj``'s entry, or with
    ``bias`` naf_expand's (WithBias, its LN in fp32); x (..., c), w (c, c_out)
    in either layout (``weight_layout``).  ``entry``, where given, is the C
    function itself (the wrappers' cached one); otherwise it is looked up in lib.
    ``tile`` -1 lets the kernel pick its block tile by shape; 0-2 force one
    (``csrc/ln_proj.cu::pick_tile``: tests and A/B tools)."""
    c, c_out = w.shape
    x = _dense(x)
    rows = x.numel() // c if c else 0
    out = torch.empty(*x.shape[:-1], c_out, dtype=x.dtype, device=x.device)
    w, ldw, k_major = weight_layout(w)
    if entry is None:
        entry = getattr(lib, ("ln_proj_" if bias is None else "naf_expand_") + _SUFFIX[x.dtype])
    args = [x.data_ptr(), _dense(ln_w).data_ptr(), _dense(ln_b).data_ptr(), w.data_ptr(), ldw, k_major]
    if bias is None:
        err = entry(*args, out.data_ptr(), rows, c, c_out, eps, int(not biasfree), tile, stream)
    else:
        err = entry(*args, _dense(bias).data_ptr(), out.data_ptr(), rows, c, c_out, eps, tile, stream)
    if err != 0:
        raise RuntimeError(f"{'ln_proj' if bias is None else 'naf_expand'} kernel launch failed with CUDA error {err}")
    return out


def on_device(x: torch.Tensor, run):
    """``run(stream)`` on x's device and its current stream: no device switch when x
    is on the current device (the B = 1 calls are set by the host)."""
    if x.device.index == torch.cuda.current_device():
        return run(torch.cuda.current_stream().cuda_stream)
    with torch.cuda.device(x.device):
        return run(torch.cuda.current_stream().cuda_stream)


def _forward(x, ln_w, ln_b, w, eps: float, biasfree: bool) -> torch.Tensor:
    if x.device.type == "cpu":
        return ln_proj_ref(x, ln_w, ln_b, w, eps, biasfree)
    c = x.shape[-1]
    check("fused_ln_proj", x, [ln_w, ln_b, w], [(c,), (c,), (c, w.shape[-1])])
    fused_ln_proj.launches += 1
    entry = _entry("ln_proj", x.dtype)
    return on_device(x, lambda stream: launch(None, x, ln_w, ln_b, w, eps, stream, biasfree=biasfree, entry=entry))


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
