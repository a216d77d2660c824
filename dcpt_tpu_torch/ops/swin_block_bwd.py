"""Whole SwinIR Swin block backward: the hand-written CUDA kernel K9 and its plain version.

Counterpart of ``dcpt_tpu/ops/swin_block_bwd.py::swin_block_bwd``: all 13
cotangents (dx, dln1_w, dln1_b, dwqkv, dbqkv, dwproj, dbproj, dln2_w, dln2_b,
dwfc1, dbfc1, dwfc2, dbfc2) of ``swin_block_map_ref`` on a (B, H, W, C) map
with windows of ws x ws shifted by ``shift``, given the upstream ``dz``, in
the op's layouts (every Linear weight (in, out), every norm weight and bias (C,)).

* ``swin_block_bwd_ref``: plain PyTorch, written as the analytic decomposition
  dcpt_tpu's ``_block_bwd_kernel`` computes (recompute the forward from x,
  then the MLP, LN2, proj, per-head attention, qkv and LN1 backward), not as
  autograd of the plain forward.
* ``swin_block_bwd``: on a CUDA tensor it launches ``csrc/swin_block_bwd.cu``
  (fp32 or bf16 x, dz and parameters, fp32 sums; every product on the TF32
  tensor cores, fp32 operands as three TF32 products), which recomputes the
  forward from x alone, or raises; on a CPU tensor it returns
  ``swin_block_bwd_ref``.  ``swin_block_bwd.launches`` counts the calls that
  launched the kernel.

Both compute in fp32 (the plain version in float64 for float64 inputs) and
return each cotangent in its primal's dtype, as dcpt_tpu's kernel does
(its ``swin_block_bwd.py:209``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .cuda_build import load_library
from .mdta_block import _wide
from .mdta_block_bwd import _ln_bwd, _ln_fwd
from .window_attention import _MAX_SMEM_BYTES, MAX_TOKENS, _block_shapes, _check, window_partition, window_reverse

_PLD = MAX_TOKENS + 4  # row stride of P and dS in the attention backward (csrc/swin_block_bwd.cu)


def attn_smem_bytes(c: int, heads: int) -> int:
    """Dynamic shared memory of one block of K9's attention backward at width C:
    the window's q, k, v and head output cotangent token-major (rows 8 HDT + 4
    floats apart, HDT = 4 8-wide tiles of the head for a head of at most 32, else
    8), P and dS, the token pixels."""
    hdt = 4 if (c // heads + 7) // 8 <= 4 else 8
    return 4 * (4 * MAX_TOKENS * (8 * hdt + 4) + 2 * MAX_TOKENS * _PLD + MAX_TOKENS)


def _windows(t: torch.Tensor, ws: int, shift: int) -> torch.Tensor:
    """(B, H, W, C) -> the (NW, N, C) windows of the map rolled by -shift."""
    return window_partition(torch.roll(t, (-shift, -shift), dims=(1, 2)) if shift else t, ws)


def swin_block_bwd_ref(x, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, ln2_w, ln2_b, wfc1, bfc1, wfc2, bfc2, dz,
                       num_heads: int, ws: int, shift: int, eps: float = 1e-5):
    """All 13 cotangents of ``swin_block_map_ref`` (dcpt_tpu's swin_block_bwd, plain):
    computed in fp32 (float64 for float64 inputs) from inputs of any float
    dtype, each returned in its primal's dtype."""
    primals = (x, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, ln2_w, ln2_b, wfc1, bfc1, wfc2, bfc2)
    x, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, ln2_w, ln2_b, wfc1, bfc1, wfc2, bfc2, dz = (
        _wide(t) for t in (*primals, dz))
    b, h, w, c = x.shape
    hd = c // num_heads
    scale = hd ** -0.5
    xw, dzw = _windows(x, ws, shift), _windows(dz, ws, shift)
    nw, n, _ = xw.shape
    sums = (0, 1)

    def heads(t):  # (NW, N, C) -> (NW, heads, N, hd)
        return t.reshape(nw, n, num_heads, hd).transpose(1, 2)

    def merge(t):  # the inverse of heads
        return t.transpose(1, 2).reshape(nw, n, c)

    def wsum(a, bb):  # sum over tokens of a[t, :, None] * bb[t, None, :]
        return a.reshape(-1, a.shape[-1]).t() @ bb.reshape(-1, bb.shape[-1])

    # recompute the forward
    xh1, mu1, inv1 = _ln_fwd(xw, eps, True)
    xn = xh1 * ln1_w + ln1_b
    q, k, v = (xn @ wqkv + bqkv).split(c, dim=-1)
    q, k, v = heads(q) * scale, heads(k), heads(v)
    attn = torch.softmax(q @ k.transpose(-2, -1), dim=-1)
    acc = merge(attn @ v)
    y = xw + acc @ wproj + bproj
    xh2, mu2, inv2 = _ln_fwd(y, eps, True)
    yn = xh2 * ln2_w + ln2_b
    pre1 = yn @ wfc1 + bfc1
    cdf = 0.5 * (1.0 + torch.erf(pre1 * 0.7071067811865476))
    g = pre1 * cdf
    gd = cdf + pre1 * 0.3989422804014327 * torch.exp(-0.5 * pre1 * pre1)

    # the MLP and LN2 backward
    dwfc2, dbfc2 = wsum(g, dzw), dzw.sum(sums)
    dpre1 = (dzw @ wfc2.t()) * gd
    dwfc1, dbfc1 = wsum(yn, dpre1), dpre1.sum(sums)
    dyn = dpre1 @ wfc1.t()
    dln2_w, dln2_b = (dyn * xh2).sum(sums), dyn.sum(sums)
    dy = dzw + _ln_bwd(dyn * ln2_w, y, xh2, mu2, inv2, True)
    # proj and the attention, head by head
    dwproj, dbproj = wsum(acc, dy), dy.sum(sums)
    dacc = heads(dy @ wproj.t())
    dattn = dacc @ v.transpose(-2, -1)
    dv = attn.transpose(-2, -1) @ dacc
    dscores = attn * (dattn - (dattn * attn).sum(-1, keepdim=True))
    dq = dscores @ k * scale
    dk = dscores.transpose(-2, -1) @ q
    dqkv = torch.cat([merge(dq), merge(dk), merge(dv)], dim=-1)
    # qkv and LN1 backward
    dwqkv, dbqkv = wsum(xn, dqkv), dqkv.sum(sums)
    dxn = dqkv @ wqkv.t()
    dln1_w, dln1_b = (dxn * xh1).sum(sums), dxn.sum(sums)
    dxw = dy + _ln_bwd(dxn * ln1_w, xw, xh1, mu1, inv1, True)
    dx = window_reverse(dxw, ws, h, w)
    if shift:
        dx = torch.roll(dx, (shift, shift), dims=(1, 2))
    grads = (dx, dln1_w, dln1_b, dwqkv, dbqkv, dwproj, dbproj, dln2_w, dln2_b, dwfc1, dbfc1, dwfc2, dbfc2)
    return tuple(g.to(p.dtype) for g, p in zip(grads, primals))


_ENTRY = {torch.float32: "swin_block_bwd_f32", torch.bfloat16: "swin_block_bwd_bf16"}


@functools.cache
def _lib() -> ctypes.CDLL:
    return _bind(load_library("swin_block_bwd", ["swin_block_bwd.cu"]))


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points of a build of ``csrc/swin_block_bwd.cu``."""
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 28 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.swin_block_bwd_workspace_floats.argtypes = [ctypes.c_int] * 7
    lib.swin_block_bwd_workspace_floats.restype = ctypes.c_longlong
    return lib


def _check_bwd(x, params, dz, heads: int, ws: int, shift: int) -> None:
    _check("swin_block_bwd", x, params, _block_shapes(x.shape[3], params[8].shape[1]), heads, ws, shift)
    if dz.shape != x.shape or dz.dtype != x.dtype or dz.device != x.device or not dz.is_contiguous():
        raise ValueError(f"swin_block_bwd: dz is {tuple(dz.shape)} {dz.dtype} on {dz.device}, the kernel takes a "
                         f"contiguous {tuple(x.shape)} {x.dtype} on {x.device}")
    if attn_smem_bytes(x.shape[3], heads) > _MAX_SMEM_BYTES:
        raise ValueError(f"swin_block_bwd: head width {x.shape[3] // heads} needs more than {_MAX_SMEM_BYTES} bytes "
                         "of shared memory a block")


def _launch(lib, x, params, dz, heads: int, ws: int, shift: int, eps: float, stream: int):
    """Allocate the cotangents (in x's dtype) and the fp32 workspace and run the
    kernel's C entry on ``stream``; returns the 13 cotangents in the op's
    layouts.  The kernel reads and writes every Linear weight in PyTorch's
    (out, in) layout, so a module's ``.t()`` view comes back as its parameter
    with no copy."""
    b, h, w, c = x.shape
    hidden = params[8].shape[1]
    io = dict(dtype=x.dtype, device=x.device)
    grads = [torch.empty_like(x), torch.empty(c, **io), torch.empty(c, **io), torch.empty((3 * c, c), **io),
             torch.empty(3 * c, **io), torch.empty((c, c), **io), torch.empty(c, **io), torch.empty(c, **io),
             torch.empty(c, **io), torch.empty((hidden, c), **io), torch.empty(hidden, **io),
             torch.empty((c, hidden), **io), torch.empty(c, **io)]
    work = torch.empty(lib.swin_block_bwd_workspace_floats(b, h, w, c, heads, hidden, int(x.dtype == torch.bfloat16)),
                       dtype=torch.float32, device=x.device)
    weights = [t.t().contiguous() if t.dim() == 2 else t.contiguous() for t in params]  # held until read
    err = getattr(lib, _ENTRY[x.dtype])(x.data_ptr(), dz.data_ptr(), *(p.data_ptr() for p in weights),
                                        *(g.data_ptr() for g in grads), work.data_ptr(), b, h, w, c, heads, ws, shift,
                                        hidden, eps, stream)
    if err != 0:
        raise RuntimeError(f"swin_block_bwd kernel launch failed with CUDA error {err}")
    return tuple(g.t() if g.dim() == 2 else g for g in grads)


def swin_block_bwd(x, ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, ln2_w, ln2_b, wfc1, bfc1, wfc2, bfc2, dz,
                   num_heads: int, ws: int, shift: int, eps: float = 1e-5):
    """All 13 cotangents: kernel K9 on a CUDA tensor, the plain version on a CPU tensor."""
    params = [ln1_w, ln1_b, wqkv, bqkv, wproj, bproj, ln2_w, ln2_b, wfc1, bfc1, wfc2, bfc2]
    if x.device.type == "cpu":
        return swin_block_bwd_ref(x, *params, dz, num_heads, ws, shift, eps)
    if x.device.type != "cuda":
        raise ValueError(f"swin_block_bwd: no kernel for device {x.device}")
    _check_bwd(x, params, dz, num_heads, ws, shift)
    swin_block_bwd.launches += 1
    with torch.cuda.device(x.device):
        return _launch(_lib(), x, params, dz, num_heads, ws, shift, eps, torch.cuda.current_stream().cuda_stream)


swin_block_bwd.launches = 0
