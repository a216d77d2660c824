"""MDTA's transposed (channel) attention: the hand-written CUDA kernel K13 and its plain version.

Counterpart of ``dcpt_tpu/ops/mdta.py::mdta_attention`` (``:158``;
``pallas_call`` ``:62`` single-shot, ``:116`` and ``:138`` the L-tiled Gram and
attn·v passes): per batch·head, with q, k, v (BH, c, L), L contiguous, and a
temperature of shape (BH,) or (BH, 1, 1), ``act(normalize(q) normalize(k)ᵀ ·
t) @ v``, the L2 norms over L (eps 1e-12), act ReLU or a row softmax.

* ``mdta_ref``: plain PyTorch, dcpt_tpu's ``mdta_ref``.
* ``mdta_attention``: on a CUDA tensor it launches ``csrc/mdta.cu`` (fp32 or
  bf16 I/O, fp32 math; three passes: chunked Gram and norms summed in chunk
  order, attn per head, attn·v by L tiles) or raises; on a CPU tensor it
  returns ``mdta_ref``.  ``mdta_attention.launches`` counts the calls that
  launched the kernel.  Under autograd it runs as ``MDTAFunction``: the kernel
  forward, the VJP of ``mdta_ref`` backward, as dcpt_tpu's custom VJP; the
  temperature's cotangent comes back in the caller's shape.

dcpt_tpu drops to ``mdta_ref`` when L % 128 != 0; the kernel takes every L
and head width.  Bound on the H100: 4·c²·L flops per head against
4·c·L·itemsize bytes, operations (``csrc/mdta.cu``).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .cuda_build import load_library


def mdta_ref(q, k, v, temperature, use_softmax: bool = False):
    """act(normalize(q) normalize(k)^T * t) @ v per batch·head, plain PyTorch; q, k, v (BH, c, L)."""
    t = temperature.reshape(q.shape[0], 1, 1)
    qn = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=1e-12)
    kn = k / torch.clamp(torch.linalg.vector_norm(k, dim=-1, keepdim=True), min=1e-12)
    attn = (qn @ kn.transpose(-2, -1)) * t
    attn = attn.softmax(-1) if use_softmax else F.relu(attn)
    return attn @ v


_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


@functools.cache
def _lib() -> ctypes.CDLL:
    return _bind(load_library("mdta", ["mdta.cu"]))


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points of a build of ``csrc/mdta.cu``."""
    for suffix in _SUFFIX.values():
        fn = getattr(lib, "mdta_" + suffix)
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.mdta_workspace_floats.argtypes = [ctypes.c_int] * 3
    lib.mdta_workspace_floats.restype = ctypes.c_longlong
    return lib


def _check(q, k, v, temperature) -> None:
    if q.dtype not in _SUFFIX:
        raise TypeError(f"mdta_attention: the kernel takes float32 or bfloat16, got {q.dtype}")
    if q.dim() != 3:
        raise ValueError(f"mdta_attention: q, k and v must be (BH, c, L), got {tuple(q.shape)}")
    for name, t in (("k", k), ("v", v), ("temperature", temperature)):
        if t.dtype != q.dtype or t.device != q.device:
            raise TypeError(f"mdta_attention: {name} is {t.dtype} on {t.device}, q is {q.dtype} on {q.device}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"mdta_attention: q, k, v have shapes {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if temperature.numel() != q.shape[0]:
        raise ValueError(f"mdta_attention: temperature must hold BH={q.shape[0]} values, "
                         f"got {tuple(temperature.shape)}")


def _launch(lib, q, k, v, temperature, use_softmax: bool, stream: int) -> torch.Tensor:
    """Allocate the output and the workspace and run the kernel's C entry on ``stream``."""
    bh, c, length = q.shape
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(v)
    ws = torch.empty(lib.mdta_workspace_floats(bh, c, length), dtype=torch.float32, device=q.device)
    err = getattr(lib, "mdta_" + _SUFFIX[q.dtype])(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                                  temperature.reshape(bh).contiguous().data_ptr(), out.data_ptr(),
                                                  ws.data_ptr(), bh, c, length, int(use_softmax), stream)
    if err != 0:
        raise RuntimeError(f"mdta_attention kernel launch failed with CUDA error {err}")
    return out


def _forward(q, k, v, temperature, use_softmax: bool) -> torch.Tensor:
    if q.device.type == "cpu":
        return mdta_ref(q, k, v, temperature, use_softmax)
    _check(q, k, v, temperature)
    mdta_attention.launches += 1
    with torch.cuda.device(q.device):
        return _launch(_lib(), q, k, v, temperature, use_softmax, torch.cuda.current_stream().cuda_stream)


class MDTAFunction(torch.autograd.Function):
    """``apply(q, k, v, temperature, use_softmax)``: K13 forward (its plain version
    on the CPU), the VJP of ``mdta_ref`` backward."""

    @staticmethod
    def forward(ctx, q, k, v, temperature, use_softmax):
        ctx.use_softmax = use_softmax
        ctx.save_for_backward(q, k, v, temperature)
        return _forward(q, k, v, temperature, use_softmax)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = mdta_ref(*inputs, ctx.use_softmax)
        return (*torch.autograd.grad(out, inputs, g), None)


def mdta_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, temperature: torch.Tensor,
                   use_softmax: bool = False) -> torch.Tensor:
    """MDTA's attention over (BH, c, L): K13 on a CUDA tensor, the plain version on a CPU tensor."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"mdta_attention: no kernel for device {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, temperature)):
        return MDTAFunction.apply(q, k, v, temperature, use_softmax)
    return _forward(q, k, v, temperature, use_softmax)


mdta_attention.launches = 0
