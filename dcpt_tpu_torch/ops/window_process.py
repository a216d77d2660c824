"""Cyclic shift fused with the Swin window partition and its inverse: CUDA kernel K11 and its plain version.

Counterpart of ``dcpt_tpu/ops/window_process.py``: ``window_partition_fused``
(``:47``, ``pallas_call`` ``:52``) takes a (B, H, W, C) channels-last map to
(B·nW, ws², C) windows after a cyclic roll by -shift, and
``window_reverse_fused`` (``:63``, ``pallas_call`` ``:70``) undoes it, the roll
by +shift included.  Source pixel of window row i, column j:
``((wy·ws + i + shift) % H, (wx·ws + j + shift) % W)``.

* ``window_partition_ref`` / ``window_reverse_ref``: plain PyTorch,
  ``torch.roll`` and a view.
* ``window_partition_fused`` / ``window_reverse_fused``: on a CUDA tensor
  they launch ``csrc/window_process.cu`` (one block per window, any dtype,
  copied bit for bit in units of up to 16 bytes) or raise; on a CPU tensor
  they return the plain versions.  ``.launches`` on each counts the calls that
  launched the kernel.

Where the port departs from dcpt_tpu: dcpt_tpu divides H and W by ws with
``//``, so on a ragged map its partition drops the uncovered rows and columns
and its reverse leaves them unwritten; both functions here raise on an H or W
that is not a multiple of ws.  dcpt_tpu defines no VJP for them, so neither
function here is differentiable: a call that would record a graph (grad mode
on, an input that requires grad) raises rather than cutting the graph.

Bound on the H100: bytes, one read and one write of every element
(2·B·H·W·C·itemsize over 3.35 TB/s).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .cuda_build import load_library


def _grid(name: str, h: int, w: int, ws: int) -> tuple[int, int]:
    if ws < 1 or h % ws or w % ws:
        raise ValueError(f"{name}: H={h} and W={w} must be multiples of window_size={ws}: dcpt_tpu's kernel would "
                         "drop the uncovered pixels of a ragged map (pad the map first)")
    return h // ws, w // ws


def _no_graph(name: str, t: torch.Tensor) -> None:
    if torch.is_grad_enabled() and t.requires_grad:
        raise RuntimeError(f"{name} has no gradient (dcpt_tpu defines no VJP for it): call it under torch.no_grad() "
                           "or on a tensor that does not require grad")


def window_partition_ref(x: torch.Tensor, window_size: int, shift: int = 0) -> torch.Tensor:
    """(B, H, W, C) -> (B·nW, ws², C) after a roll by -shift, plain PyTorch."""
    b, h, w, c = x.shape
    ny, nx = _grid("window_partition_fused", h, w, window_size)
    if shift:
        x = torch.roll(x, (-shift, -shift), (1, 2))
    ws = window_size
    return x.reshape(b, ny, ws, nx, ws, c).permute(0, 1, 3, 2, 4, 5).reshape(b * ny * nx, ws * ws, c)


def window_reverse_ref(windows: torch.Tensor, window_size: int, h: int, w: int, shift: int = 0) -> torch.Tensor:
    """(B·nW, ws², C) -> (B, H, W, C), then a roll by +shift, plain PyTorch."""
    ny, nx = _grid("window_reverse_fused", h, w, window_size)
    ws, c = window_size, windows.shape[-1]
    b = windows.shape[0] // (ny * nx)
    x = windows.reshape(b, ny, nx, ws, ws, c).permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)
    return torch.roll(x, (shift, shift), (1, 2)) if shift else x


@functools.cache
def _lib() -> ctypes.CDLL:
    return _bind(load_library("window_process", ["window_process.cu"]))


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry point of a build of ``csrc/window_process.cu``."""
    lib.window_process.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    lib.window_process.restype = ctypes.c_int
    return lib


def _launch(lib, src: torch.Tensor, out: torch.Tensor, b: int, h: int, w: int, c: int, ws: int, shift: int,
            reverse: bool, stream: int) -> torch.Tensor:
    """Run the kernel's C entry on ``stream``: src (contiguous) into the preallocated out.
    A pixel's c elements move as the widest unit of 16, 8, 4, 2 or 1 bytes that
    divides the pixel and aligns both buffers (16 bytes for SwinIR's 180 fp32
    channels), so any dtype is copied bit for bit."""
    pixel = c * src.element_size()
    unit = next(u for u in (16, 8, 4, 2, 1) if pixel % u == 0 and src.data_ptr() % u == 0 and out.data_ptr() % u == 0)
    err = lib.window_process(src.data_ptr(), out.data_ptr(), b, h, w, pixel // unit, ws, shift % h, shift % w, unit,
                             int(reverse), stream)
    if err != 0:
        raise RuntimeError(f"window_process kernel launch failed with CUDA error {err}")
    return out


def _device(name: str, t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises on any other device."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {t.device}")
    return t.device.type == "cuda"


def window_partition_fused(x: torch.Tensor, window_size: int, shift: int = 0) -> torch.Tensor:
    """(B, H, W, C) -> (B·nW, ws², C) with the cyclic -shift fused in: K11 on a
    CUDA tensor, the plain version on a CPU tensor."""
    _no_graph("window_partition_fused", x)
    if x.dim() != 4:
        raise ValueError(f"window_partition_fused: x must be (B, H, W, C), got {tuple(x.shape)}")
    if not _device("window_partition_fused", x):
        return window_partition_ref(x, window_size, shift)
    b, h, w, c = x.shape
    ny, nx = _grid("window_partition_fused", h, w, window_size)
    out = torch.empty(b * ny * nx, window_size * window_size, c, dtype=x.dtype, device=x.device)
    window_partition_fused.launches += 1
    with torch.cuda.device(x.device):
        return _launch(_lib(), x.contiguous(), out, b, h, w, c, window_size, shift, False,
                       torch.cuda.current_stream().cuda_stream)


def window_reverse_fused(windows: torch.Tensor, window_size: int, h: int, w: int, shift: int = 0) -> torch.Tensor:
    """(B·nW, ws², C) -> (B, H, W, C) with the cyclic +shift fused in: K11 on a
    CUDA tensor, the plain version on a CPU tensor."""
    _no_graph("window_reverse_fused", windows)
    ny, nx = _grid("window_reverse_fused", h, w, window_size)
    if windows.dim() != 3 or windows.shape[1] != window_size * window_size or windows.shape[0] % (ny * nx):
        raise ValueError(f"window_reverse_fused: windows must be (B·{ny * nx}, {window_size ** 2}, C) for a {h}x{w} "
                         f"map, got {tuple(windows.shape)}")
    if not _device("window_reverse_fused", windows):
        return window_reverse_ref(windows, window_size, h, w, shift)
    b, c = windows.shape[0] // (ny * nx), windows.shape[-1]
    out = torch.empty(b, h, w, c, dtype=windows.dtype, device=windows.device)
    window_reverse_fused.launches += 1
    with torch.cuda.device(windows.device):
        return _launch(_lib(), windows.contiguous(), out, b, h, w, c, window_size, shift, True,
                       torch.cuda.current_stream().cuda_stream)


window_partition_fused.launches = 0
window_reverse_fused.launches = 0
