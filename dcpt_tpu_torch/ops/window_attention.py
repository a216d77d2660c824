"""SwinIR's window attention and whole Swin block: the hand-written CUDA kernels K8 and K10 and their plain versions.

Counterpart of ``dcpt_tpu/ops/window_attention.py``.  The window functions
take dcpt_tpu's layouts: windows (NW, N, C) with N = ws * ws tokens, every
Linear weight (in, out), every norm weight and bias (C,).

* ``window_attention_ref`` / ``swin_block_ref``: plain PyTorch on (NW, N, C)
  windows of the rolled map (dcpt_tpu's twins of the same names).
* ``window_partition`` / ``window_reverse``: (B, H, W, C) <-> (B * nW, N, C).
* ``window_attention_map_ref`` / ``swin_block_map_ref``: the same functions on
  a (B, H, W, C) map, as dcpt_tpu's SwinTransformerBlock composes them: roll
  by -shift, partition, the window function, reverse, roll back.  These are
  what the kernels are held against.
* ``fused_swin_block`` (K8, ``csrc/swin_block.cu``) and
  ``fused_window_attention`` / ``fused_window_attention_ln`` (K10,
  ``csrc/window_attention.cu``): on a CUDA tensor they launch the kernel
  (fp32 or bf16 I/O, TF32 tensor-core products split to fp32 accuracy) or
  raise; on a CPU tensor they return the map-level plain version.  The
  kernels never roll or partition: each reads a
  window's tokens by index from the map and writes its result back to the
  same pixels, which is the same function.  ``fused_swin_block.launches``
  and ``fused_window_attention.launches`` (for both K10 functions) count the
  calls that launched a kernel.
* Under autograd ``fused_swin_block`` runs ``SwinBlockFunction``: on the card
  K8 forward, keeping only x and the parameters, and the backward kernel K9
  (``ops/swin_block_bwd.py``), which recomputes the forward; on the CPU the
  plain forward and K9's plain version.  The K10 functions run
  ``WindowAttentionFunction``: the forward K10 (or its plain version), the
  backward the VJP of ``window_attention_map_ref``, as dcpt_tpu's custom VJP
  differentiates its twin.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .cuda_build import load_library
from .naf_block import layer_norm_last

# what one block of the kernels holds in shared memory (csrc/swin_window.cuh, WinLayout)
MAX_TOKENS = 64
_MAX_SMEM_BYTES = 232448
_BN, _WLD, _STAGES = 192, 24, 4  # a weight product's columns a pass, a weight chunk's row stride, chunks in the ring
_HID = _BN + 8  # row stride of a hidden chunk


def _pad8(n: int) -> int:
    return (n + 7) // 8 * 8


def _ld(n: int) -> int:
    """Row stride of a token-major map of n columns: padded to 8, and 8 (mod 16)."""
    return _pad8(n) + (8 if _pad8(n) % 16 == 0 else 0)


def smem_bytes(c: int, heads: int) -> int:
    """Dynamic shared memory of one block of K8 or K10 at width C (``WinLayout::floats``)."""
    hdp = _pad8(c // heads)
    group = 2 if heads > 1 and 6 * hdp <= _BN else 1
    head = 2 * MAX_TOKENS * _ld(hdp) + hdp * _ld(MAX_TOKENS)
    floats = 2 * MAX_TOKENS * _ld(c) + max(group * head, MAX_TOKENS * _HID) + _STAGES * _BN * _WLD + MAX_TOKENS
    return 4 * floats


def kernel_takes(c: int, heads: int, ws: int) -> bool:
    """Whether K8 and K10 take this block: ws * ws <= 64 tokens a window, heads of
    at most 64 channels (a head's q, k and v in one 192-column product) and the
    window's buffers within a block's 227 KB of shared memory."""
    return (heads >= 1 and c % heads == 0 and c // heads <= 64 and 1 <= ws * ws <= MAX_TOKENS
            and smem_bytes(c, heads) <= _MAX_SMEM_BYTES)


def window_attention_ref(x, wqkv, bqkv, wproj, bproj, num_heads: int, ln: tuple | None = None):
    """x (NW, N, C) windows -> qkv -> per-head softmax(q k^T * hd^-0.5) v -> proj;
    ``ln`` = optional (weight, bias, eps) of a LayerNorm applied first."""
    nw, n, c = x.shape
    hd = c // num_heads
    if ln is not None:
        x = layer_norm_last(x, *ln)
    qkv = (x @ wqkv + bqkv).reshape(nw, n, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    attn = torch.softmax((q * hd ** -0.5) @ k.transpose(-2, -1), dim=-1)
    out = (attn @ v).transpose(1, 2).reshape(nw, n, c)
    return out @ wproj + bproj


def swin_block_ref(x, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, ln2_w, ln2_b, wfc1, bfc1, wfc2, bfc2,
                   num_heads: int, eps: float = 1e-5):
    """The whole Swin block over (NW, N, C) windows of the rolled map: the
    attention branch with LN1 and the shortcut, then LN2 -> fc1 -> exact-erf
    GELU -> fc2 and the second shortcut.  The LayerNorms keep torch's
    semantics (``layer_norm_last``: fp32 statistics, eps 1e-5 here)."""
    y = x + window_attention_ref(layer_norm_last(x, ln1_w, ln1_b, eps), wqkv, bqkv, wproj, bproj, num_heads)
    return y + F.gelu(layer_norm_last(y, ln2_w, ln2_b, eps) @ wfc1 + bfc1) @ wfc2 + bfc2


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nW, ws * ws, C), windows in row-major order."""
    b, h, w, c = x.shape
    return x.reshape(b, h // ws, ws, w // ws, ws, c).transpose(2, 3).reshape(-1, ws * ws, c)


def window_reverse(windows: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    """The inverse of ``window_partition``."""
    b = windows.shape[0] // ((h // ws) * (w // ws))
    return windows.reshape(b, h // ws, w // ws, ws, ws, -1).transpose(2, 3).reshape(b, h, w, -1)


def on_windows(x: torch.Tensor, ws: int, shift: int, fn) -> torch.Tensor:
    """roll(-shift) -> partition -> fn -> reverse -> roll(+shift) on a (B, H, W, C) map."""
    b, h, w, c = x.shape
    if shift:
        x = torch.roll(x, (-shift, -shift), dims=(1, 2))
    out = window_reverse(fn(window_partition(x, ws)), ws, h, w)
    return torch.roll(out, (shift, shift), dims=(1, 2)) if shift else out


def swin_block_map_ref(x, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, ln2_w, ln2_b, wfc1, bfc1, wfc2, bfc2,
                       num_heads: int, ws: int, shift: int, eps: float = 1e-5):
    """``swin_block_ref`` on the windows of a (B, H, W, C) map shifted by ``shift``."""
    params = (ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, ln2_w, ln2_b, wfc1, bfc1, wfc2, bfc2)
    return on_windows(x, ws, shift, lambda t: swin_block_ref(t, *params, num_heads, eps))


def window_attention_map_ref(x, wqkv, bqkv, wproj, bproj, num_heads: int, ws: int, shift: int,
                             ln: tuple | None = None):
    """``window_attention_ref`` on the windows of a (B, H, W, C) map shifted by ``shift``."""
    return on_windows(x, ws, shift, lambda t: window_attention_ref(t, wqkv, bqkv, wproj, bproj, num_heads, ln))


_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


@functools.cache
def _block_lib() -> ctypes.CDLL:
    return _bind_block(load_library("swin_block", ["swin_block.cu"]))


@functools.cache
def _attn_lib() -> ctypes.CDLL:
    return _bind_attn(load_library("window_attention", ["window_attention.cu"]))


def _bind_block(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points of a build of ``csrc/swin_block.cu``."""
    for suffix in _DTYPES.values():
        fn = getattr(lib, f"swin_block_fwd_{suffix}")
        fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _bind_attn(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points of a build of ``csrc/window_attention.cu``."""
    for suffix in _DTYPES.values():
        fn = getattr(lib, f"window_attention_fwd_{suffix}")
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check(name: str, x: torch.Tensor, params: list[torch.Tensor], shapes: list[tuple], heads: int, ws: int,
           shift: int) -> None:
    if x.dim() != 4 or not x.is_contiguous() or x.numel() == 0:
        raise ValueError(f"{name}: x must be a non-empty contiguous (B, H, W, C) tensor, got {tuple(x.shape)} "
                         f"with strides {x.stride()}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name}: the kernel takes float32 or bfloat16, got {x.dtype}")
    _, h, w, c = x.shape
    if not kernel_takes(c, heads, ws):
        raise ValueError(f"{name}: the kernel takes C % heads == 0, heads of at most 64 channels, ws * ws <= "
                         f"{MAX_TOKENS} and a window within {_MAX_SMEM_BYTES} bytes of shared memory; got C={c}, "
                         f"heads={heads}, ws={ws}")
    if h % ws or w % ws or not 0 <= shift < ws:
        raise ValueError(f"{name}: H={h} and W={w} must be multiples of ws={ws}, and 0 <= shift={shift} < ws")
    for i, (p, shape) in enumerate(zip(params, shapes)):
        if tuple(p.shape) != shape:
            raise ValueError(f"{name}: parameter {i + 1} has shape {tuple(p.shape)}, the kernel takes {shape}")
        if p.device != x.device or p.dtype != x.dtype:
            raise TypeError(f"{name}: parameter {i + 1} is {p.dtype} on {p.device}, x is {x.dtype} on {x.device}")


def _device_ok(name: str, x: torch.Tensor) -> None:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {x.device}")


def _launch_block(lib, x, params, heads: int, ws: int, shift: int, eps: float, stream: int) -> torch.Tensor:
    """Allocate z and run K8's C entry on ``stream``.  The kernel reads every
    Linear weight as (out, in), PyTorch's own layout, so a module's ``.t()``
    view comes back as its parameter with no copy."""
    b, h, w, c = x.shape
    hidden = params[8].shape[1]
    z = torch.empty_like(x)
    weights = [t.t().contiguous() if t.dim() == 2 else t.contiguous() for t in params]
    err = getattr(lib, f"swin_block_fwd_{_DTYPES[x.dtype]}")(
        x.data_ptr(), *(p.data_ptr() for p in weights), z.data_ptr(), b, h, w, c, heads, ws, shift, hidden, eps,
        stream)
    if err != 0:
        raise RuntimeError(f"swin_block kernel launch failed with CUDA error {err}")
    return z


def _launch_attn(lib, x, params, heads: int, ws: int, shift: int, ln: tuple | None, stream: int) -> torch.Tensor:
    """Allocate the output and run K10's C entry on ``stream``; params = (wqkv,
    bqkv, wproj, bproj) in the op's layout, ``ln`` = (weight, bias, eps) or None."""
    b, h, w, c = x.shape
    wqkv, bqkv, wproj, bproj = params
    lnw, lnb, eps = ln if ln is not None else (bproj, bproj, 0.0)  # not read without the LayerNorm
    out = torch.empty_like(x)
    weights = [t.t().contiguous() if t.dim() == 2 else t.contiguous() for t in (lnw, lnb, wqkv, bqkv, wproj, bproj)]
    err = getattr(lib, f"window_attention_fwd_{_DTYPES[x.dtype]}")(
        x.data_ptr(), *(p.data_ptr() for p in weights), out.data_ptr(), b, h, w, c, heads, ws, shift,
        int(ln is not None), eps, stream)
    if err != 0:
        raise RuntimeError(f"window_attention kernel launch failed with CUDA error {err}")
    return out


def _block_shapes(c: int, hidden: int) -> list[tuple]:
    return [(c,), (c,), (c, 3 * c), (3 * c,), (c, c), (c,), (c,), (c,), (c, hidden), (hidden,), (hidden, c), (c,)]


def _kernel_block(x, params: list, heads: int, ws: int, shift: int, eps: float) -> torch.Tensor:
    """Check the inputs, count the launch and run K8 on x's device and current stream."""
    _check("fused_swin_block", x, params, _block_shapes(x.shape[3], params[8].shape[1]), heads, ws, shift)
    fused_swin_block.launches += 1
    with torch.cuda.device(x.device):
        return _launch_block(_block_lib(), x, params, heads, ws, shift, eps, torch.cuda.current_stream().cuda_stream)


def _differentiated(x, params) -> bool:
    return torch.is_grad_enabled() and (x.requires_grad or any(p.requires_grad for p in params))


class SwinBlockFunction(torch.autograd.Function):
    """The whole Swin block with its analytic backward (dcpt_tpu's ``custom_vjp``), fp32 or bf16.

    ``apply(x, heads, ws, shift, eps, *params)``; on the card the forward is K8,
    which keeps nothing but x and the parameters, and the backward K9, which
    recomputes the forward from x; on the CPU both are the plain versions."""

    @staticmethod
    def forward(ctx, x, heads, ws, shift, eps, *params):
        if x.device.type == "cpu":
            z = swin_block_map_ref(x, *params, heads, ws, shift, eps)
        else:
            z = _kernel_block(x, list(params), heads, ws, shift, eps)
        ctx.config = (heads, ws, shift, eps)
        ctx.save_for_backward(x, *params)
        return z

    @staticmethod
    def backward(ctx, dz):
        from .swin_block_bwd import swin_block_bwd

        x, *params = ctx.saved_tensors
        grads = swin_block_bwd(x, *params, dz.contiguous(), *ctx.config)
        return (grads[0], None, None, None, None, *grads[1:])


def fused_swin_block(x, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, ln2_w, ln2_b, wfc1, bfc1, wfc2, bfc2,
                     num_heads: int, ws: int, shift: int, eps: float = 1e-5):
    """The whole Swin block on a (B, H, W, C) map with windows of ws x ws shifted
    by ``shift``: kernel K8 on a CUDA tensor, ``swin_block_map_ref`` on a CPU
    tensor; under autograd through ``SwinBlockFunction`` (K9 backward)."""
    params = [ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, ln2_w, ln2_b, wfc1, bfc1, wfc2, bfc2]
    _device_ok("fused_swin_block", x)
    if _differentiated(x, params):
        return SwinBlockFunction.apply(x, num_heads, ws, shift, eps, *params)
    if x.device.type == "cpu":
        return swin_block_map_ref(x, *params, num_heads, ws, shift, eps)
    return _kernel_block(x, params, num_heads, ws, shift, eps)


fused_swin_block.launches = 0


class WindowAttentionFunction(torch.autograd.Function):
    """The attention branch under autograd, as dcpt_tpu's K10 custom VJP: the
    forward K10 (its plain version on the CPU), the backward the VJP of
    ``window_attention_map_ref`` on the saved inputs; dcpt_tpu has no backward
    kernel for it.  ``apply(x, heads, ws, shift, ln_eps, wqkv, bqkv, wproj,
    bproj[, ln_w, ln_b])``, ``ln_eps`` None without the LayerNorm."""

    @staticmethod
    def forward(ctx, x, heads, ws, shift, ln_eps, *params):
        ctx.config = (heads, ws, shift, ln_eps)
        ctx.save_for_backward(x, *params)
        return _attention_forward(x, list(params[:4]), heads, ws, shift, (*params[4:], ln_eps) if params[4:] else None)

    @staticmethod
    def backward(ctx, dout):
        heads, ws, shift, ln_eps = ctx.config
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        x, wqkv, bqkv, wproj, bproj, *ln = inputs
        with torch.enable_grad():
            out = window_attention_map_ref(x, wqkv, bqkv, wproj, bproj, heads, ws, shift,
                                           (*ln, ln_eps) if ln else None)
        grads = torch.autograd.grad(out, inputs, dout)
        return (grads[0], None, None, None, None, *grads[1:])


def _attention_forward(x, params: list, num_heads: int, ws: int, shift: int, ln: tuple | None):
    if x.device.type == "cpu":
        return window_attention_map_ref(x, *params, num_heads, ws, shift, ln)
    name = "fused_window_attention" + ("_ln" if ln else "")
    c = x.shape[3]
    _check(name, x, params + list(ln[:2] if ln else ()), [(c, 3 * c), (3 * c,), (c, c), (c,), (c,), (c,)],
           num_heads, ws, shift)
    fused_window_attention.launches += 1
    with torch.cuda.device(x.device):
        return _launch_attn(_attn_lib(), x, params, num_heads, ws, shift, ln, torch.cuda.current_stream().cuda_stream)


def _attention(name: str, x, params: list, num_heads: int, ws: int, shift: int, ln: tuple | None):
    _device_ok(name, x)
    if _differentiated(x, params + list(ln[:2] if ln else ())):
        return WindowAttentionFunction.apply(x, num_heads, ws, shift, ln[2] if ln else None, *params,
                                             *(ln[:2] if ln else ()))
    return _attention_forward(x, params, num_heads, ws, shift, ln)


def fused_window_attention(x, wqkv, bqkv, wproj, bproj, num_heads: int, ws: int, shift: int):
    """The attention branch of a Swin block (qkv -> per-head softmax attention
    -> proj) on a (B, H, W, C) map: kernel K10 on a CUDA tensor,
    ``window_attention_map_ref`` on a CPU tensor."""
    return _attention("fused_window_attention", x, [wqkv, bqkv, wproj, bproj], num_heads, ws, shift, None)


def fused_window_attention_ln(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, num_heads: int, ws: int, shift: int,
                              ln_eps: float = 1e-5):
    """As ``fused_window_attention`` with LN1 folded in: kernel K10 with its LayerNorm on."""
    return _attention("fused_window_attention_ln", x, [wqkv, bqkv, wproj, bproj], num_heads, ws, shift,
                      (ln_w, ln_b, ln_eps))


fused_window_attention.launches = 0
