"""Whole-NAFBlock forward: the hand-written CUDA kernel K1 and its plain twin.

Counterpart of ``dcpt_tpu/ops/naf_block.py::naf_block_fused``.  Both functions
take the JAX op's layouts: the map is (B, H, W, C) channels-last, every 1x1
weight is (in, out), the depthwise weight is (3, 3, dw), and beta / gamma are
(C,).  A module passes its PyTorch parameters as transposed views; the wrapper
transposes them back, which costs nothing for such views.

* ``naf_block_ref``: plain PyTorch, what the kernel must compute.
* ``naf_block_fused``: on a CUDA tensor it launches the kernel in
  ``csrc/naf_block.cu`` (fp32 or bf16 I/O, fp32 math, the 1x1 products on
  the tensor cores) or raises; on a CPU
  tensor it returns ``naf_block_ref``.  ``naf_block_fused.launches`` counts
  the calls that launched the kernel.

Under autograd (grad mode on and x or a parameter requiring a gradient) the
block runs as ``NAFBlockFunction``, the counterpart of dcpt_tpu's
``jax.custom_vjp``: its forward saves x, the parameters and the SCA residuals
``pooled`` / ``att`` (and on the card the maps the backward reads, see
``csrc/naf_block_bwd.cu``), its backward returns the 19 cotangents from
kernel K2 (``ops/naf_block_bwd.py``).  On a CPU tensor the same Function runs
the plain forward and K2's plain version.  In bf16 (mixed-precision training)
the Function is K1 in bf16 forward and K2 in bf16 backward, as dcpt_tpu under
``DCPT_TPU_NAF_BLOCK=1 DCPT_TPU_NAF_BWD=1``: K1 keeps g in bf16 and its other
residuals in fp32, and K2 does its math in fp32.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .cuda_build import load_library


def layer_norm_last(t: torch.Tensor, weight, bias, eps: float) -> torch.Tensor:
    """Channel LayerNorm over the last axis: statistics in fp32 or wider (biased
    variance), the normalised map back in the input dtype, then the affine
    (dcpt_tpu's LayerNorm2d)."""
    tf = t if t.dtype == torch.float64 else t.float()
    mu = tf.mean(-1, keepdim=True)
    var = ((tf - mu) ** 2).mean(-1, keepdim=True)
    return ((tf - mu) * torch.rsqrt(var + eps)).to(t.dtype) * weight + bias


def _ref_forward(x, n1w, n1b, w1, b1, wdw, bdw, wsca, bsca, w3, b3, beta,
                 n2w, n2b, w4, b4, w5, b5, gamma, eps: float):
    """naf_block_ref's output and its SCA residuals pooled, att (B, C)."""
    dw = w1.shape[1]
    ffn = w4.shape[1]
    t = layer_norm_last(x, n1w, n1b, eps) @ w1 + b1
    # depthwise 3x3 with zero padding of the expanded map t
    t = F.conv2d(t.permute(0, 3, 1, 2), wdw.permute(2, 0, 1).unsqueeze(1), bdw, padding=1, groups=dw)
    t = t.permute(0, 2, 3, 1)
    g = t[..., : dw // 2] * t[..., dw // 2 :]
    pooled = g.mean(dim=(1, 2))
    att = pooled @ wsca + bsca
    y = x + ((g * att[:, None, None, :]) @ w3 + b3) * beta
    h = layer_norm_last(y, n2w, n2b, eps) @ w4 + b4
    out = (h[..., : ffn // 2] * h[..., ffn // 2 :]) @ w5 + b5
    return y + out * gamma, pooled, att


def naf_block_ref(x, n1w, n1b, w1, b1, wdw, bdw, wsca, bsca, w3, b3, beta,
                  n2w, n2b, w4, b4, w5, b5, gamma, eps: float = 1e-6):
    """The full NAFBlock on (B, H, W, C) in plain PyTorch (dcpt_tpu's naf_block_ref)."""
    return _ref_forward(x, n1w, n1b, w1, b1, wdw, bdw, wsca, bsca, w3, b3, beta,
                        n2w, n2b, w4, b4, w5, b5, gamma, eps)[0]


_ENTRY = {torch.float32: "naf_block_fwd_f32", torch.bfloat16: "naf_block_fwd_bf16"}


@functools.cache
def _lib() -> ctypes.CDLL:
    return _bind(load_library("naf_block", ["naf_block.cu"]))


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points of a build of ``csrc/naf_block.cu``."""
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 30 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.naf_block_scratch_floats.argtypes = [ctypes.c_int] * 4
    lib.naf_block_scratch_floats.restype = ctypes.c_longlong
    return lib


def _check(x: torch.Tensor, params: list[torch.Tensor]) -> None:
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"naf_block_fused: x must be a contiguous (B, H, W, C) tensor, got {tuple(x.shape)} "
                         f"with strides {x.stride()}")
    if x.dtype not in _ENTRY:
        raise TypeError(f"naf_block_fused: the kernel takes float32 or bfloat16, got {x.dtype}")
    c = x.shape[3]
    if c % 64 or not 64 <= c <= 8192:
        raise ValueError(f"naf_block_fused: the kernel takes C in 64..8192 in steps of 64, got C={c}")
    shapes = [(c,), (c,), (c, 2 * c), (2 * c,), (3, 3, 2 * c), (2 * c,), (c, c), (c,), (c, c), (c,), (c,),
              (c,), (c,), (c, 2 * c), (2 * c,), (c, c), (c,), (c,)]
    for i, (p, shape) in enumerate(zip(params, shapes)):
        if tuple(p.shape) != shape:
            raise ValueError(f"naf_block_fused: parameter {i + 1} has shape {tuple(p.shape)}, the kernel "
                             f"takes {shape} (dw = ffn = 2C)")
        if p.device != x.device or p.dtype != x.dtype:
            raise TypeError(f"naf_block_fused: parameter {i + 1} is {p.dtype} on {p.device}, x is {x.dtype} "
                            f"on {x.device}")


def torch_layout(params) -> list[torch.Tensor]:
    """The 18 parameters as the CUDA kernels read them: every 1x1 as (out, in),
    the depthwise weight as (dw, 3, 3), contiguous (free for a module's views)."""
    n1w, n1b, w1, b1, wdw, bdw, wsca, bsca, w3, b3, beta, n2w, n2b, w4, b4, w5, b5, gamma = params
    weights = [n1w, n1b, w1.t(), b1, wdw.permute(2, 0, 1), bdw, wsca.t(), bsca, w3.t(), b3, beta,
               n2w, n2b, w4.t(), b4, w5.t(), b5, gamma]
    return [t.contiguous() for t in weights]


def _launch(lib, x, params, eps: float, stream: int, residuals: bool = False):
    """Allocate the output and scratch and run the kernel's C entry on ``stream``.

    Returns z, or with ``residuals`` (z, res): res = (g, t, u, y, h, o,
    pooled, att), the maps the backward kernel reads (g in x's dtype, the
    others fp32)."""
    b, h, w, c = x.shape
    weights = torch_layout(params)
    f32 = dict(dtype=torch.float32, device=x.device)
    g = torch.empty_like(x)
    part = torch.empty(lib.naf_block_scratch_floats(b, h, w, c), **f32)
    att = torch.empty((b, c), **f32)
    y = torch.empty((b, h, w, c), **f32)
    hidden = torch.empty_like(y)
    z = torch.empty_like(x)
    if residuals:
        saved = [torch.empty((b, c), **f32), torch.empty((b, h, w, 2 * c), **f32), torch.empty_like(y),
                 torch.empty((b, h, w, 2 * c), **f32), torch.empty_like(y)]  # pooled, t, u, h, o
        saved_ptrs = [t.data_ptr() for t in saved]
    else:
        saved_ptrs = [None] * 5
    err = getattr(lib, _ENTRY[x.dtype])(
        x.data_ptr(), *(t.data_ptr() for t in weights), g.data_ptr(), part.data_ptr(), att.data_ptr(),
        y.data_ptr(), hidden.data_ptr(), z.data_ptr(), *saved_ptrs, b, h, w, c, eps, stream)
    if err != 0:
        raise RuntimeError(f"naf_block kernel launch failed with CUDA error {err}")
    if not residuals:
        return z
    pooled, t, u, hh, o = saved
    return z, (g, t, u, y, hh, o, pooled, att)


def _kernel_forward(x, params, eps: float, residuals: bool = False):
    """Check the inputs, count the launch and run K1 on x's device and current stream."""
    _check(x, params)
    naf_block_fused.launches += 1
    with torch.cuda.device(x.device):
        return _launch(_lib(), x, params, eps, torch.cuda.current_stream().cuda_stream, residuals)


class NAFBlockFunction(torch.autograd.Function):
    """The NAFBlock with its analytic backward (dcpt_tpu's ``custom_vjp``), fp32 or bf16.

    ``apply(x, eps, *params)``; on the card the forward is K1 writing its
    residuals and the backward K2, on the CPU both are the plain versions."""

    @staticmethod
    def forward(ctx, x, eps, *params):
        if x.device.type == "cpu":
            z, pooled, att = _ref_forward(x, *params, eps)
            res = ()
        else:
            z, res = _kernel_forward(x, list(params), eps, residuals=True)
            pooled, att = res[-2:]
            res = res[:-2]
        ctx.eps = eps
        ctx.save_for_backward(x, *params, pooled, att, *res)
        return z

    @staticmethod
    def backward(ctx, dz):
        from .naf_block_bwd import naf_block_bwd

        x, *saved = ctx.saved_tensors
        params, (pooled, att), res = saved[:18], saved[18:20], saved[20:]
        grads = naf_block_bwd(x, *params, pooled, att, dz, res, ctx.eps)
        return (grads[0], None, *grads[1:])


def _needs_grad(x, params) -> bool:
    return torch.is_grad_enabled() and (x.requires_grad or any(p.requires_grad for p in params))


def naf_block_fused(x, n1w, n1b, w1, b1, wdw, bdw, wsca, bsca, w3, b3, beta,
                    n2w, n2b, w4, b4, w5, b5, gamma, eps: float = 1e-6):
    """The whole NAFBlock over (B, H, W, C): the CUDA kernel on a CUDA tensor,
    the plain twin on a CPU tensor."""
    params = [n1w, n1b, w1, b1, wdw, bdw, wsca, bsca, w3, b3, beta, n2w, n2b, w4, b4, w5, b5, gamma]
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"naf_block_fused: no kernel for device {x.device}")
    if _needs_grad(x, params):
        return NAFBlockFunction.apply(x, eps, *params)
    if x.device.type == "cpu":
        return naf_block_ref(x, *params, eps)
    return _kernel_forward(x, params, eps)


naf_block_fused.launches = 0
