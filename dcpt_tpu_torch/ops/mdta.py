"""MDTA's transposed (channel) attention: the hand-written CUDA kernel K13 and its plain version.

Counterpart of ``dcpt_tpu/ops/mdta.py::mdta_attention`` (``:158``;
``pallas_call`` ``:62`` single-shot, ``:116`` and ``:138`` the L-tiled Gram and
attn·v passes): per batch·head, with q, k, v (BH, c, L), L contiguous, and a
temperature of shape (BH,) or (BH, 1, 1), ``act(normalize(q) normalize(k)ᵀ ·
t) @ v``, the L2 norms over L (eps 1e-12), act ReLU or a row softmax.

* ``mdta_ref``: plain PyTorch, dcpt_tpu's ``mdta_ref``.
* ``mdta_attention``: on a CUDA tensor it launches ``csrc/mdta.cu`` or
  raises; on a CPU tensor it returns ``mdta_ref``.  ``mdta_attention.launches``
  counts the calls that launched the kernel.  Under autograd it runs as
  ``MDTAFunction``: the kernel forward, the VJP of ``mdta_ref`` backward, as
  dcpt_tpu's custom VJP; the temperature's cotangent comes back in the
  caller's shape.

The kernel (fp32 or bf16 I/O) runs the Gram and attn·v on the tensor cores
(``mma.sync`` TF32 through ``csrc/tc_gemm.cuh``'s pieces, 3xTF32 for fp32
operands): the Gram and the norms by chunks of L across blocks, the chunks
summed in chunk order and attn taken by a pass over rows, or by the Gram's
own block where one chunk and one tile cover a head; then attn·v.  Two or
three launches a call (``launches_per_call``).  The host path is one ctypes
call: the entry resolved once, the workspace size reckoned here from the
shape (``workspace_floats``, equal to the C entry ``mdta_workspace_floats``)
and no device switch for a tensor on the current device.

dcpt_tpu drops to ``mdta_ref`` when L % 128 != 0; the kernel takes every L
and head widths up to 8192.  Bound on the H100: 4·c²·L flops per head against
4·c·L·itemsize bytes, bytes under 3xTF32 on the tensor cores (``csrc/mdta.cu``).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .cuda_build import entry, load_library, on_device


def mdta_ref(q, k, v, temperature, use_softmax: bool = False):
    """act(normalize(q) normalize(k)^T * t) @ v per batch·head, plain PyTorch; q, k, v (BH, c, L)."""
    t = temperature.reshape(q.shape[0], 1, 1)
    qn = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=1e-12)
    kn = k / torch.clamp(torch.linalg.vector_norm(k, dim=-1, keepdim=True), min=1e-12)
    attn = (qn @ kn.transpose(-2, -1)) * t
    attn = attn.softmax(-1) if use_softmax else F.relu(attn)
    return attn @ v


_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
# csrc/mdta.cu's chunking of L for the Gram: kMinLen, kOneChunk, kTargetBlocks, the 32-pixel unit
_MIN_LEN, _ONE_CHUNK, _TARGET_BLOCKS, _KC = 128, 256, 2 * 132, 32


@functools.cache
def _lib() -> ctypes.CDLL:
    return _bind(load_library("mdta", ["mdta.cu"]))


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points of a build of ``csrc/mdta.cu``."""
    for suffix in _SUFFIX.values():
        fn = getattr(lib, "mdta_" + suffix)
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.mdta_workspace_floats.argtypes, lib.mdta_workspace_floats.restype = [ctypes.c_int] * 3, ctypes.c_longlong
    return lib


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def num_chunks(bh: int, c: int, length: int) -> int:
    """The chunks of L the kernel's Gram takes (``csrc/mdta.cu::chunk_len``): enough to
    fill the card with bh heads of ceil(c / 96)² tiles, each a multiple of 32 pixels
    and at least 128 on a map of more than 256; such a map is one chunk where c <= 96."""
    if length <= _ONE_CHUNK and c <= 96:
        return 1
    want = _ceil(_TARGET_BLOCKS, _ceil(c, 96) ** 2 * bh)
    size = _ceil(_ceil(length, want), _KC) * _KC
    return _ceil(length, max(_MIN_LEN, size) if length > _ONE_CHUNK else size)


@functools.cache
def workspace_floats(bh: int, c: int, length: int) -> int:
    """Floats of the kernel's workspace for (bh, c, L): the chunks' Gram partials and
    norms (bh, chunks, c² + 2c), then attn (bh, c, c); the C entry
    ``mdta_workspace_floats`` reckons the same."""
    if not (bh and c and length):
        return 0
    return bh * num_chunks(bh, c, length) * (c * c + 2 * c) + bh * c * c


def launches_per_call(bh: int, c: int, length: int) -> int:
    """Kernel launches of one call at its own tile: two where one chunk and one Gram
    tile (48 square where c <= 48, else 96) cover a head, else three."""
    if not (bh and c and length):
        return 0
    return 2 if num_chunks(bh, c, length) == 1 and c <= 96 else 3


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
    if q.shape[1] > 8192:
        raise ValueError(f"mdta_attention: the kernel takes head widths up to 8192, got {q.shape[1]}")


def _dense(t: torch.Tensor) -> torch.Tensor:
    return t if t.is_contiguous() else t.contiguous()


def _launch(lib, q, k, v, temperature, use_softmax: bool, stream: int, tile: int = -1, fn=None) -> torch.Tensor:
    """Allocate the output and the workspace and run the kernel's C entry on ``stream``
    (``fn``, the wrapper's cached one, or else lib's); ``tile`` -1 lets the kernel
    pick its tile by c, 0 or 1 force the 48 or 96 family (tests and A/B tools)."""
    bh, c, length = q.shape
    q, k, v, t = _dense(q), _dense(k), _dense(v), _dense(temperature)  # t's BH values in order either shape
    out = torch.empty_like(v)
    ws = torch.empty(workspace_floats(bh, c, length), dtype=torch.float32, device=q.device)
    if fn is None:
        fn = getattr(lib, "mdta_" + _SUFFIX[q.dtype])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), t.data_ptr(), out.data_ptr(), ws.data_ptr(), bh, c, length,
             int(use_softmax), tile, stream)
    if err != 0:
        raise RuntimeError(f"mdta_attention kernel launch failed with CUDA error {err}")
    return out


def _forward(q, k, v, temperature, use_softmax: bool) -> torch.Tensor:
    if not q.is_cuda:
        return mdta_ref(q, k, v, temperature, use_softmax)
    _check(q, k, v, temperature)
    mdta_attention.launches += 1
    fn = entry(_lib, "mdta_" + _SUFFIX[q.dtype])
    return on_device(q, lambda stream: _launch(None, q, k, v, temperature, use_softmax, stream, fn=fn))


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
    if not (q.is_cuda or q.is_cpu):
        raise ValueError(f"mdta_attention: no kernel for device {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad
                                    or temperature.requires_grad):
        return MDTAFunction.apply(q, k, v, temperature, use_softmax)
    return _forward(q, k, v, temperature, use_softmax)


mdta_attention.launches = 0
