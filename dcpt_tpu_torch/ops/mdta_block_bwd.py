"""Whole Restormer / PromptIR TransformerBlock backward: the hand-written CUDA kernel K7 and its plain version.

Counterpart of ``dcpt_tpu/ops/mdta_block_bwd.py::mdta_block_bwd``: all 12
cotangents of ``mdta_block_ref`` given the upstream ``dz``, in the op's layouts
(x (B, H, W, C), every 1x1 weight (in, out), the depthwise weights (3, 3, D),
temperature (heads, 1, 1)).

* ``mdta_block_bwd_ref``: plain PyTorch, written as the analytic decomposition
  the kernels use (dcpt_tpu's B1: the GDFN and attention-application
  backward; the C-space step: activation, temperature and L2-norm backward;
  B2: the qkv-prefix backward), not as autograd of the plain forward.
* ``mdta_block_bwd``: on a CUDA tensor it launches ``csrc/mdta_block_bwd.cu``
  (fp32) with the residuals K6 kept, or raises; on a CPU tensor it returns
  ``mdta_block_bwd_ref``.  ``mdta_block_bwd.launches`` counts the calls that
  launched the kernel.

BiasFree blocks return zero LayerNorm-bias cotangents, as dcpt_tpu does: their
bias is not a parameter (``archs/restormer_arch.py``'s ``affine``).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .cuda_build import load_library
from .mdta_block import _check as check_forward
from .mdta_block import _dwconv, torch_layout

_TAPS = [(dy, dx) for dy in range(3) for dx in range(3)]


def _ln_fwd(t: torch.Tensor, eps: float, ln_bias: bool):
    """(xh, mu, inv): xh is the normalised map before the weight (uncentred for BiasFree)."""
    mu = t.mean(-1, keepdim=True)
    inv = torch.rsqrt(((t - mu) ** 2).mean(-1, keepdim=True) + eps)
    return ((t - mu) if ln_bias else t) * inv, mu, inv


def _ln_bwd(dl, t, xh, mu, inv, ln_bias: bool):
    """d/dt of the normalised map given its cotangent dl (the weight folded in)."""
    if ln_bias:
        return inv * (dl - dl.mean(-1, keepdim=True) - xh * (dl * xh).mean(-1, keepdim=True))
    return inv * dl - inv ** 3 * (t - mu) * (dl * t).mean(-1, keepdim=True)


def _wsum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum over pixels of a[p, :, None] * b[p, None, :]: (B, H, W, M), (B, H, W, N) -> (M, N)."""
    return a.reshape(-1, a.shape[-1]).t() @ b.reshape(-1, b.shape[-1])


def _dw_bwd(dd: torch.Tensor, t: torch.Tensor, wdw: torch.Tensor):
    """The depthwise 3x3 (zero padding) backward: (cotangent of its input, tap gradient (3, 3, D))."""
    _, h, w, _ = t.shape
    tp = F.pad(t, (0, 0, 1, 1, 1, 1))
    ddp = F.pad(dd, (0, 0, 1, 1, 1, 1))
    dwdw = torch.stack([(dd * tp[:, dy:dy + h, dx:dx + w]).sum((0, 1, 2)) for dy, dx in _TAPS])
    dt = sum(ddp[:, 2 - dy:2 - dy + h, 2 - dx:2 - dx + w] * wdw[dy, dx] for dy, dx in _TAPS)
    return dt, dwdw.reshape(3, 3, -1)


def cspace_bwd_ref(dattn, attn, gram, qn2, kn2, temperature, heads: int, use_softmax: bool):
    """The C-space step (dcpt_tpu's host micro-step): from dattn (B, C, C), attn,
    the raw Gram's head blocks (B, C, ch) and the squared norms (B, C) to the
    dense dgram (B, C, C), dqn2, dkn2 (B, C) and dtemperature (heads, 1, 1)."""
    b, c, ch = gram.shape
    head = torch.arange(c) // ch
    blk = (head[:, None] == head[None, :]).to(gram.device)
    full = torch.zeros(b, c, c, dtype=gram.dtype, device=gram.device)
    full[:, blk] = gram.reshape(b, -1)  # row c's block, in column order
    iq = torch.rsqrt(qn2.clamp_min(1e-24))
    ik = torch.rsqrt(kn2.clamp_min(1e-24))
    ngram = full * iq[:, :, None] * ik[:, None, :]
    temp = temperature.reshape(heads).repeat_interleave(ch)[None, :, None]
    if use_softmax:
        ds = attn * (dattn - (dattn * attn).sum(-1, keepdim=True))
    else:
        ds = torch.where(blk & (ngram * temp > 0), dattn, torch.zeros((), dtype=dattn.dtype, device=dattn.device))
    dtemp = (torch.where(blk, ds * ngram, 0.0).sum((0, 2)).reshape(heads, ch).sum(1)).reshape(heads, 1, 1)
    dsn = ds * temp
    dgram = dsn * iq[:, :, None] * ik[:, None, :]
    dqn2 = (dsn * full * ik[:, None, :]).sum(2) * -0.5 * iq ** 3 * (qn2 > 1e-24)
    dkn2 = (dsn * full * iq[:, :, None]).sum(1) * -0.5 * ik ** 3 * (kn2 > 1e-24)
    return dgram, dqn2, dkn2, dtemp


def mdta_block_bwd_ref(x, n1w, n1b, wqkv, wdwq, temperature, wproj, n2w, n2b, win_, wdwf, wout,
                       gram, qn2, kn2, attn, dz, heads: int, use_softmax: bool, ln_bias: bool, eps: float):
    """All 12 cotangents of mdta_block_ref in fp32 (dcpt_tpu's mdta_block_bwd, plain).

    ``gram`` (B, C, ch), ``qn2``, ``kn2`` (B, C) and ``attn`` (B, C, C) are the
    forward's residuals; everything else is recomputed from x."""
    c = x.shape[-1]
    f = wout.shape[0]
    sums = (0, 1, 2)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    # B1: recompute the forward
    xh1, mu1, inv1 = _ln_fwd(x, eps, ln_bias)
    ln1 = xh1 * n1w + (n1b if ln_bias else zero)
    t = ln1 @ wqkv
    qkv = _dwconv(t, wdwq)
    q, k, v = qkv.split(c, dim=-1)
    o = torch.einsum("bhwd,bcd->bhwc", v, attn)
    y = x + o @ wproj
    xh2, mu2, inv2 = _ln_fwd(y, eps, ln_bias)
    ln2 = xh2 * n2w + (n2b if ln_bias else zero)
    u = ln2 @ win_
    dwu = _dwconv(u, wdwf)
    a, bv = dwu[..., :f], dwu[..., f:]
    cdf = 0.5 * (1.0 + torch.erf(a * 0.7071067811865476))
    pdf = 0.3989422804014327 * torch.exp(-0.5 * a * a)
    g = a * cdf * bv

    # B1: the GDFN backward
    dwout = _wsum(g, dz)
    dg = dz @ wout.t()
    dd = torch.cat([dg * bv * (cdf + a * pdf), dg * a * cdf], dim=-1)
    du, dwdwf = _dw_bwd(dd, u, wdwf)
    dwin = _wsum(ln2, du)
    dln2 = du @ win_.t()
    dn2w = (dln2 * xh2).sum(sums)
    dn2b = dln2.sum(sums) if ln_bias else torch.zeros_like(n2b)
    dy = dz + _ln_bwd(dln2 * n2w, y, xh2, mu2, inv2, ln_bias)
    # B1: the attention application's backward
    dwproj = _wsum(o, dy)
    dout = dy @ wproj.t()
    dattn = torch.einsum("bhwc,bhwd->bcd", dout, v)
    dv = torch.einsum("bhwc,bcd->bhwd", dout, attn)

    # the C-space step
    dgram, dqn2, dkn2, dtemp = cspace_bwd_ref(dattn, attn, gram, qn2, kn2, temperature, heads, use_softmax)

    # B2: the qkv prefix's backward
    dq = torch.einsum("bhwd,bcd->bhwc", k, dgram) + 2 * q * dqn2[:, None, None, :]
    dk = torch.einsum("bhwc,bcd->bhwd", q, dgram) + 2 * k * dkn2[:, None, None, :]
    dt, dwdwq = _dw_bwd(torch.cat([dq, dk, dv], dim=-1), t, wdwq)
    dwqkv = _wsum(ln1, dt)
    dln1 = dt @ wqkv.t()
    dn1w = (dln1 * xh1).sum(sums)
    dn1b = dln1.sum(sums) if ln_bias else torch.zeros_like(n1b)
    dx = dy + _ln_bwd(dln1 * n1w, x, xh1, mu1, inv1, ln_bias)
    return dx, dn1w, dn1b, dwqkv, dwdwq, dtemp, dwproj, dn2w, dn2b, dwin, dwdwf, dwout


@functools.cache
def _lib() -> ctypes.CDLL:
    return _bind(load_library("mdta_block_bwd", ["mdta_block_bwd.cu"]))


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points of a build of ``csrc/mdta_block_bwd.cu``."""
    lib.mdta_block_bwd_f32.argtypes = [ctypes.c_void_p] * 36 + [ctypes.c_int] * 8 + [ctypes.c_float,
                                                                                     ctypes.c_void_p]
    lib.mdta_block_bwd_f32.restype = ctypes.c_int
    lib.mdta_block_bwd_workspace_floats.argtypes = [ctypes.c_int] * 6
    lib.mdta_block_bwd_workspace_floats.restype = ctypes.c_longlong
    return lib


def _check(x, params, dz, res, heads: int) -> None:
    check_forward(x, params, heads)
    if x.dtype != torch.float32:
        raise TypeError(f"mdta_block_bwd: the kernel takes float32, got {x.dtype}")
    b, h, w, c = x.shape
    f, ch = params[-1].shape[0], c // heads
    shapes = [(b, h, w, c), (b, c, ch), (b, c), (b, c), (b, c, c), (b, h, w, 3 * c), (b, h, w, 3 * c), (b, h, w, c),
              (b, h, w, c), (b, h, w, 2 * f), (b, h, w, f)]
    names = ["dz", "gram", "qn2", "kn2", "attn", "t", "qkv", "o", "y", "u", "g"]
    if len(res) != 10:
        raise ValueError("mdta_block_bwd: the kernel needs K6's residuals (gram, qn2, kn2, attn, t, qkv, o, y, u, g)")
    for name, m, shape in zip(names, [dz, *res], shapes):
        if tuple(m.shape) != shape or m.dtype != torch.float32 or m.device != x.device or not m.is_contiguous():
            raise ValueError(f"mdta_block_bwd: {name} is {tuple(m.shape)} {m.dtype} on {m.device}, the kernel "
                             f"takes a contiguous {shape} float32 on {x.device}")


def _launch(lib, x, params, dz, res, heads: int, use_softmax: bool, ln_bias: bool, eps: float, stream: int):
    """Allocate the cotangents and workspace and run the kernel's C entry on
    ``stream``; returns the 12 cotangents in the op's layouts."""
    b, h, w, c = x.shape
    f = params[-1].shape[0]
    f32 = dict(dtype=torch.float32, device=x.device)
    # PyTorch's layouts: 1x1 weights (out, in), the depthwise gradients (3, 3, D), temperature (heads,)
    grads = [torch.empty_like(x), torch.empty(c, **f32), torch.empty(c, **f32), torch.empty((3 * c, c), **f32),
             torch.empty((3, 3, 3 * c), **f32), torch.empty(heads, **f32), torch.empty((c, c), **f32),
             torch.empty(c, **f32), torch.empty(c, **f32), torch.empty((2 * f, c), **f32),
             torch.empty((3, 3, 2 * f), **f32), torch.empty((c, f), **f32)]
    ws = torch.empty(lib.mdta_block_bwd_workspace_floats(b, h, w, c, f, heads), **f32)
    weights = torch_layout(params)  # held until the kernel has read them
    err = lib.mdta_block_bwd_f32(x.data_ptr(), dz.data_ptr(), *(p.data_ptr() for p in weights),
                                 *(r.data_ptr() for r in res), *(g.data_ptr() for g in grads), ws.data_ptr(),
                                 b, h, w, c, f, heads, int(use_softmax), int(ln_bias), eps, stream)
    if err != 0:
        raise RuntimeError(f"mdta_block_bwd kernel launch failed with CUDA error {err}")
    # back to the op's layouts: every 1x1 weight gradient (in, out), temperature (heads, 1, 1)
    for i in (3, 6, 9, 11):
        grads[i] = grads[i].t()
    grads[5] = grads[5].view(heads, 1, 1)
    return tuple(grads)


def mdta_block_bwd(x, n1w, n1b, wqkv, wdwq, temperature, wproj, n2w, n2b, win_, wdwf, wout, dz, res,
                   heads: int, use_softmax: bool, ln_bias: bool, eps: float = 1e-6):
    """All 12 cotangents: kernel K7 on a CUDA tensor, the plain version on a CPU tensor.

    ``res`` is what the differentiated forward kept: (gram, qn2, kn2, attn) on
    the CPU, and K6's maps (t, qkv, o, y, u, g) after them on the card."""
    params = [n1w, n1b, wqkv, wdwq, temperature, wproj, n2w, n2b, win_, wdwf, wout]
    if x.device.type == "cpu":
        return mdta_block_bwd_ref(x, *params, *res[:4], dz, heads, use_softmax, ln_bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"mdta_block_bwd: no kernel for device {x.device}")
    _check(x, params, dz, res, heads)
    mdta_block_bwd.launches += 1
    with torch.cuda.device(x.device):
        return _launch(_lib(), x, params, dz, res, heads, use_softmax, ln_bias, eps,
                       torch.cuda.current_stream().cuda_stream)


mdta_block_bwd.launches = 0
