"""Whole-NAFBlock backward: the hand-written CUDA kernel K2 and its plain version.

Counterpart of ``dcpt_tpu/ops/naf_block_bwd.py::naf_block_bwd``: all 19
cotangents of ``naf_block_ref`` given the upstream ``dz``, in the op's layouts
(x (B, H, W, C), every 1x1 weight (in, out), the depthwise weight (3, 3, dw)).

* ``naf_block_bwd_ref``: plain PyTorch, written as the analytic decomposition
  the kernels use (dcpt_tpu's B1 stage-2 backward, host SCA step, B2 prefix
  backward), not as autograd of the twin.
* ``naf_block_bwd``: on a CUDA tensor it launches ``csrc/naf_block_bwd.cu``
  (fp32 or bf16 I/O, fp32 math) with the forward's residuals ``res`` =
  (g, t, u, y, h, o) that K1 wrote (g in the I/O type, the others fp32), or
  raises; on a CPU tensor it returns ``naf_block_bwd_ref`` (which
  needs no residuals beyond pooled and att).  ``naf_block_bwd.launches``
  counts the calls that launched the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .cuda_build import load_library
from .naf_block import _check as check_forward
from .naf_block import torch_layout


def _ln_fwd(t: torch.Tensor, eps: float):
    mu = t.mean(-1, keepdim=True)
    var = ((t - mu) ** 2).mean(-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    return (t - mu) * inv, inv


def _ln_bwd(dxh, xh, inv):
    """d/dx of xh = (x - mu) * inv given the cotangent dxh (affine weight folded in)."""
    return inv * (dxh - dxh.mean(-1, keepdim=True) - xh * (dxh * xh).mean(-1, keepdim=True))


def _wsum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum over pixels of a[p, :, None] * b[p, None, :]: (B, H, W, M), (B, H, W, N) -> (M, N)."""
    return a.reshape(-1, a.shape[-1]).t() @ b.reshape(-1, b.shape[-1])


def naf_block_bwd_ref(x, n1w, n1b, w1, b1, wdw, bdw, wsca, bsca, w3, b3, beta,
                      n2w, n2b, w4, b4, w5, b5, gamma, pooled, att, dz, eps: float = 1e-6):
    """All 19 cotangents of naf_block_ref (dcpt_tpu's naf_block_bwd, plain): the
    math in fp32 (float64 stays float64), each cotangent in its primal's dtype."""
    primals = (x, n1w, n1b, w1, b1, wdw, bdw, wsca, bsca, w3, b3, beta, n2w, n2b, w4, b4, w5, b5, gamma)
    if x.dtype != torch.float64:
        grads = _bwd_math(*(t.float() for t in (*primals, pooled, att, dz)), eps)
        return tuple(gr.to(p.dtype) for gr, p in zip(grads, primals))
    return _bwd_math(*primals, pooled, att, dz, eps)


def _bwd_math(x, n1w, n1b, w1, b1, wdw, bdw, wsca, bsca, w3, b3, beta,
              n2w, n2b, w4, b4, w5, b5, gamma, pooled, att, dz, eps: float):
    _, h, w, c = x.shape
    sums = (0, 1, 2)
    # B1: recompute the prefix and stage 2, then the stage-2 backward
    xh1, inv1 = _ln_fwd(x, eps)
    ln1 = xh1 * n1w + n1b
    t = ln1 @ w1 + b1
    tp = F.pad(t, (0, 0, 1, 1, 1, 1))  # zero padding of t, as the forward's dwconv
    taps = [(dy, dx) for dy in range(3) for dx in range(3)]
    dwm = bdw + sum(tp[:, dy:dy + h, dx:dx + w] * wdw[dy, dx] for dy, dx in taps)
    g = dwm[..., :c] * dwm[..., c:]
    a = g * att[:, None, None, :]
    u = a @ w3 + b3
    y = x + u * beta
    yh, inv2 = _ln_fwd(y, eps)
    ln2 = yh * n2w + n2b
    hh = ln2 @ w4 + b4
    h1, h2 = hh[..., :c], hh[..., c:]
    hg = h1 * h2
    o = hg @ w5 + b5

    dgamma = (dz * o).sum(sums)
    do = dz * gamma
    dw5, db5 = _wsum(hg, do), do.sum(sums)
    dhg = do @ w5.t()
    dh = torch.cat([dhg * h2, dhg * h1], dim=-1)
    dw4, db4 = _wsum(ln2, dh), dh.sum(sums)
    dln2 = dh @ w4.t()
    dn2w, dn2b = (dln2 * yh).sum(sums), dln2.sum(sums)
    dy = dz + _ln_bwd(dln2 * n2w, yh, inv2)
    dbeta = (dy * u).sum(sums)
    du = dy * beta
    dw3, db3 = _wsum(a, du), du.sum(sums)
    da = du @ w3.t()
    datt = (da * g).sum((1, 2))  # (B, C)

    # host SCA step: the global coupling through the pooled mean
    dwsca, dbsca = pooled.t() @ datt, datt.sum(0)
    dgk = (datt @ wsca.t()) / (h * w)

    # B2: the prefix backward
    dg = da * att[:, None, None, :] + dgk[:, None, None, :]
    ddw = torch.cat([dg * dwm[..., c:], dg * dwm[..., :c]], dim=-1)
    dbdw = ddw.sum(sums)
    dwdw = torch.stack([(ddw * tp[:, dy:dy + h, dx:dx + w]).sum(sums) for dy, dx in taps]).reshape(3, 3, -1)
    ddwp = F.pad(ddw, (0, 0, 1, 1, 1, 1))
    dt = sum(ddwp[:, 2 - dy:2 - dy + h, 2 - dx:2 - dx + w] * wdw[dy, dx] for dy, dx in taps)
    dw1, db1 = _wsum(ln1, dt), dt.sum(sums)
    dln1 = dt @ w1.t()
    dn1w, dn1b = (dln1 * xh1).sum(sums), dln1.sum(sums)
    dx = dy + _ln_bwd(dln1 * n1w, xh1, inv1)
    return (dx, dn1w, dn1b, dw1, db1, dwdw, dbdw, dwsca, dbsca, dw3, db3, dbeta,
            dn2w, dn2b, dw4, db4, dw5, db5, dgamma)


@functools.cache
def _lib() -> ctypes.CDLL:
    return _bind(load_library("naf_block_bwd", ["naf_block_bwd.cu"]))


_ENTRY = {torch.float32: "naf_block_bwd_f32", torch.bfloat16: "naf_block_bwd_bf16"}


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points of a build of ``csrc/naf_block_bwd.cu``."""
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 43 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.naf_block_bwd_workspace_floats.argtypes = [ctypes.c_int] * 5
    lib.naf_block_bwd_workspace_floats.restype = ctypes.c_longlong
    return lib


def _check(x, params, maps) -> None:
    check_forward(x, params)
    b, h, w, c = x.shape
    shapes = [(b, h, w, c)] * 2 + [(b, h, w, c), (b, h, w, 2 * c), (b, h, w, c), (b, h, w, c), (b, h, w, 2 * c),
                                   (b, h, w, c), (b, c), (b, c)]
    names = ["x", "dz", "g", "t", "u", "y", "h", "o", "pooled", "att"]
    for name, m, shape in zip(names, maps, shapes):
        dtype = x.dtype if name in ("x", "dz", "g") else torch.float32
        if tuple(m.shape) != shape:
            raise ValueError(f"naf_block_bwd: {name} is {tuple(m.shape)}, the kernel takes {shape}")
        if m.dtype != dtype or m.device != x.device:
            raise TypeError(f"naf_block_bwd: {name} is {m.dtype} on {m.device}, the kernel takes {dtype} on "
                            f"{x.device} (x, dz and g in x's dtype, the other residuals fp32)")


def _launch(lib, x, params, pooled, att, dz, res, eps: float, stream: int):
    """Allocate the cotangents and workspace and run the kernel's C entry on ``stream``;
    returns the 19 cotangents in the op's layouts."""
    b, h, w, c = x.shape
    (n1w, n1b, w1, _, wdw, bdw, wsca, _, w3, _, beta, n2w, n2b, w4, _, w5, _, gamma) = torch_layout(params)
    maps = [t.contiguous() for t in (x, dz, *res, pooled, att)]
    io = dict(dtype=x.dtype, device=x.device)
    # in the I/O type, PyTorch's layouts: 1x1 weights (out, in), the depthwise weight (3, 3, 2C)
    grads = [torch.empty((b, h, w, c), **io), torch.empty(c, **io), torch.empty(c, **io),
             torch.empty((2 * c, c), **io), torch.empty(2 * c, **io), torch.empty((3, 3, 2 * c), **io),
             torch.empty(2 * c, **io), torch.empty((c, c), **io), torch.empty(c, **io), torch.empty((c, c), **io),
             torch.empty(c, **io), torch.empty(c, **io), torch.empty(c, **io), torch.empty(c, **io),
             torch.empty((2 * c, c), **io), torch.empty(2 * c, **io), torch.empty((c, c), **io),
             torch.empty(c, **io), torch.empty(c, **io)]
    ws = torch.empty(lib.naf_block_bwd_workspace_floats(b, h, w, c, int(x.dtype == torch.bfloat16)),
                     dtype=torch.float32, device=x.device)
    weights = [n1w, n1b, w1, wdw, bdw, wsca, w3, beta, n2w, n2b, w4, w5, gamma]
    x_, dz_, *maps_rest = maps
    err = getattr(lib, _ENTRY[x.dtype])(x_.data_ptr(), dz_.data_ptr(), *(t.data_ptr() for t in weights),
                                        *(t.data_ptr() for t in maps_rest), *(t.data_ptr() for t in grads),
                                        ws.data_ptr(), b, h, w, c, eps, stream)
    if err != 0:
        raise RuntimeError(f"naf_block_bwd kernel launch failed with CUDA error {err}")
    # back to the op's layouts: every 1x1 weight gradient (in, out)
    for i in (3, 7, 9, 14, 16):
        grads[i] = grads[i].t()
    return tuple(grads)


def naf_block_bwd(x, n1w, n1b, w1, b1, wdw, bdw, wsca, bsca, w3, b3, beta,
                  n2w, n2b, w4, b4, w5, b5, gamma, pooled, att, dz, res, eps: float = 1e-6):
    """All 19 cotangents: kernel K2 on a CUDA tensor, the plain version on a CPU tensor.

    ``res`` = (g, t, u, y, h, o) from K1's differentiated forward (unused on the CPU)."""
    params = [n1w, n1b, w1, b1, wdw, bdw, wsca, bsca, w3, b3, beta, n2w, n2b, w4, b4, w5, b5, gamma]
    if x.device.type == "cpu":
        return naf_block_bwd_ref(x, *params, pooled, att, dz, eps)
    if x.device.type != "cuda":
        raise ValueError(f"naf_block_bwd: no kernel for device {x.device}")
    if len(res) != 6:
        raise ValueError("naf_block_bwd: the kernel needs the forward's residuals (g, t, u, y, h, o)")
    _check(x, params, [x, dz, *res, pooled, att])
    naf_block_bwd.launches += 1
    with torch.cuda.device(x.device):
        return _launch(_lib(), x, params, pooled, att, dz, res, eps, torch.cuda.current_stream().cuda_stream)


naf_block_bwd.launches = 0
