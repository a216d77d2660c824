"""Whole Restormer / PromptIR TransformerBlock forward: the hand-written CUDA kernel K6 and its plain version.

Counterpart of ``dcpt_tpu/ops/mdta_block.py::mdta_block_fused``.  Both
functions take the JAX op's layouts: the map is (B, H, W, C) channels-last,
every 1x1 weight is (in, out), the depthwise weights are (3, 3, D), the norm
weights and biases are (C,) and ``temperature`` is (heads, 1, 1).  A module
passes its PyTorch parameters as views; the wrapper lays them out as the
kernel reads them, which costs nothing for such views.

* ``mdta_block_ref``: plain PyTorch, what the kernel must compute.
* ``attn_from_stats``: the (B, C, C) attention from the raw Gram and the
  squared norms, under the block-diagonal head mask (ReLU or softmax).
* ``mdta_block_fused``: on a CUDA tensor it launches the kernel in
  ``csrc/mdta_block.cu`` (fp32 or bf16 I/O, fp32 math, the 1x1 products on
  the tensor cores) or raises; on a CPU
  tensor it returns ``mdta_block_ref``.  ``mdta_block_fused.launches`` counts
  the calls that launched the kernel.

Under autograd (grad mode on and x or a parameter requiring a gradient) the
block runs as ``MDTABlockFunction``, the counterpart of dcpt_tpu's
``jax.custom_vjp``: on the card its forward is K6 keeping its residuals (the
Gram's head blocks, the squared norms, attn, and the maps t, qkv, o, y, u, g
that the backward reads, see ``csrc/mdta_block_bwd.cu``) and its backward
kernel K7 (``ops/mdta_block_bwd.py``), in fp32 or bf16 (the residuals fp32 in
both); on a CPU tensor the same Function runs the plain forward and K7's plain
version.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .cuda_build import load_library


def _wide(t: torch.Tensor) -> torch.Tensor:
    """t in fp32, or as it is when it is wider (a float64 reference keeps float64)."""
    return t if t.dtype == torch.float64 else t.float()


def ln_channel(x2: torch.Tensor, weight, bias, eps: float, ln_bias: bool) -> torch.Tensor:
    """Channel LayerNorm over the last axis of fp32 rows: BiasFree keeps the
    uncentred output with the centred variance (reference restormer_arch.py:26-41)."""
    mu = x2.mean(-1, keepdim=True)
    var = ((x2 - mu) ** 2).mean(-1, keepdim=True)
    if ln_bias:
        return (x2 - mu) * torch.rsqrt(var + eps) * weight + bias
    return x2 * torch.rsqrt(var + eps) * weight


def _dwconv(t: torch.Tensor, wdw: torch.Tensor) -> torch.Tensor:
    """Depthwise 3x3 with zero padding on (B, H, W, D), wdw (3, 3, D)."""
    d = t.shape[-1]
    out = F.conv2d(t.permute(0, 3, 1, 2), wdw.permute(2, 0, 1).unsqueeze(1), padding=1, groups=d)
    return out.permute(0, 2, 3, 1)


def attn_from_stats(gram, qn2, kn2, temperature, heads: int, use_softmax: bool) -> torch.Tensor:
    """(B, C, C) raw Gram + (B, C) squared norms -> the masked attention, fp32 (or float64)
    (dcpt_tpu's ``_attn_from_stats``; F.normalize's eps: x / max(|x|, 1e-12))."""
    _, c, _ = gram.shape
    ch = c // heads
    attn = gram * torch.rsqrt(qn2.clamp_min(1e-24))[:, :, None]
    attn = attn * torch.rsqrt(kn2.clamp_min(1e-24))[:, None, :]
    attn = attn * temperature.reshape(heads).repeat_interleave(ch)[None, :, None]
    head = torch.arange(c, device=gram.device) // ch
    blk = head[:, None] == head[None, :]
    if use_softmax:
        return _wide(torch.softmax(attn.masked_fill(~blk, float("-inf")), dim=-1))
    return _wide(torch.where(blk, torch.relu(attn), torch.zeros((), dtype=attn.dtype, device=attn.device)))


def head_blocks(full: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, C, C) -> (B, C, ch): row c keeps the columns of c's head."""
    b, c, _ = full.shape
    ch = c // heads
    return full.reshape(b, heads, ch, heads, ch).diagonal(dim1=1, dim2=3).permute(0, 3, 1, 2).reshape(b, c, ch)


def _ref_forward(x, n1w, n1b, wqkv, wdwq, temperature, wproj, n2w, n2b, win_, wdwf, wout,
                 heads: int, use_softmax: bool, ln_bias: bool, eps: float):
    """mdta_block_ref's output and the residuals K6 keeps for the backward:
    the raw Gram's head blocks (B, C, ch), |q|^2 and |k|^2 (B, C), attn (B, C, C)."""
    b, h, w, c = x.shape
    ln1 = ln_channel(_wide(x.reshape(-1, c)), n1w, n1b, eps, ln_bias).reshape(b, h, w, c).to(x.dtype)
    qkv = _wide(_dwconv(ln1 @ wqkv, wdwq))
    q, k, v = qkv.reshape(b, h * w, 3 * c).split(c, dim=-1)
    gram = torch.einsum("bpc,bpd->bcd", q, k)
    qn2, kn2 = (q * q).sum(1), (k * k).sum(1)
    attn = attn_from_stats(gram, qn2, kn2, temperature, heads, use_softmax)
    out = torch.einsum("bpd,bcd->bpc", v, attn)
    y = x + out.reshape(b, h, w, c).to(x.dtype) @ wproj

    ln2 = ln_channel(_wide(y.reshape(-1, c)), n2w, n2b, eps, ln_bias).reshape(b, h, w, c).to(y.dtype)
    t2 = _dwconv(ln2 @ win_, wdwf)
    f2 = t2.shape[-1] // 2
    gated = F.gelu(_wide(t2[..., :f2])) * _wide(t2[..., f2:])
    return y + gated.to(y.dtype) @ wout, (head_blocks(gram, heads), qn2, kn2, attn)


def mdta_block_ref(x, n1w, n1b, wqkv, wdwq, temperature, wproj, n2w, n2b, win_, wdwf, wout,
                   heads: int, use_softmax: bool, ln_bias: bool, eps: float):
    """The whole TransformerBlock on (B, H, W, C) in plain PyTorch (dcpt_tpu's
    ``mdta_block_ref``): statistics in fp32 (float64 for a float64 input), 1x1 products
    as matmuls, exact-erf GELU."""
    return _ref_forward(x, n1w, n1b, wqkv, wdwq, temperature, wproj, n2w, n2b, win_, wdwf, wout,
                        heads, use_softmax, ln_bias, eps)[0]


_ENTRY = {torch.float32: "mdta_block_fwd_f32", torch.bfloat16: "mdta_block_fwd_bf16"}


@functools.cache
def _lib() -> ctypes.CDLL:
    return _bind(load_library("mdta_block", ["mdta_block.cu"]))


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points of a build of ``csrc/mdta_block.cu``."""
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 22 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.mdta_block_scratch_floats.argtypes = [ctypes.c_int] * 6
    lib.mdta_block_scratch_floats.restype = ctypes.c_longlong
    return lib


def _check(x: torch.Tensor, params: list[torch.Tensor], heads: int) -> None:
    if x.dim() != 4 or not x.is_contiguous() or x.numel() == 0:
        raise ValueError(f"mdta_block_fused: x must be a non-empty contiguous (B, H, W, C) tensor, got "
                         f"{tuple(x.shape)} with strides {x.stride()}")
    if x.dtype not in _ENTRY:
        raise TypeError(f"mdta_block_fused: the kernel takes float32 or bfloat16, got {x.dtype}")
    c = x.shape[3]
    if heads < 1 or c % heads:
        raise ValueError(f"mdta_block_fused: C={c} does not split into {heads} heads")
    f = params[-1].shape[0]
    shapes = [(c,), (c,), (c, 3 * c), (3, 3, 3 * c), (heads, 1, 1), (c, c), (c,), (c,), (c, 2 * f), (3, 3, 2 * f),
              (f, c)]
    for i, (p, shape) in enumerate(zip(params, shapes)):
        if tuple(p.shape) != shape:
            raise ValueError(f"mdta_block_fused: parameter {i + 1} has shape {tuple(p.shape)}, the kernel takes "
                             f"{shape} (C={c}, F={f}, heads={heads})")
        if p.device != x.device or p.dtype != x.dtype:
            raise TypeError(f"mdta_block_fused: parameter {i + 1} is {p.dtype} on {p.device}, x is {x.dtype} "
                            f"on {x.device}")


def torch_layout(params) -> list[torch.Tensor]:
    """The 11 parameters as the kernel reads them: every 1x1 as (out, in), the
    depthwise weights as (D, 3, 3), temperature as (heads,), contiguous."""
    n1w, n1b, wqkv, wdwq, temperature, wproj, n2w, n2b, win_, wdwf, wout = params
    weights = [n1w, n1b, wqkv.t(), wdwq.permute(2, 0, 1), temperature.reshape(-1), wproj.t(), n2w, n2b, win_.t(),
               wdwf.permute(2, 0, 1), wout.t()]
    return [t.contiguous() for t in weights]


def _launch(lib, x, params, heads: int, use_softmax: bool, ln_bias: bool, eps: float, stream: int,
            residuals: bool = False):
    """Allocate the output and the fp32 scratch and run the kernel's C entry on ``stream``.

    Returns z, or with ``residuals`` (z, (gram, qn2, kn2, attn, t, qkv, o, y,
    u, g)): the head blocks of the raw Gram (B, C, ch), the squared norms
    (B, C) and attn (B, C, C), contiguous, then the forward's maps t, qkv
    (B, H, W, 3C; v is qkv[..., 2C:]), o, y (B, H, W, C), u (B, H, W, 2F) and
    g (B, H, W, F), all fp32: what the backward K7 reads."""
    b, h, w, c = x.shape
    f = params[-1].shape[0]
    ch = c // heads
    f32 = dict(dtype=torch.float32, device=x.device)
    t = torch.empty((b, h, w, 3 * c), **f32)
    qkv = torch.empty_like(t)
    part = torch.empty(lib.mdta_block_scratch_floats(b, h, w, c, f, heads), **f32)
    red = torch.empty((b, c * ch + 2 * c), **f32)
    attn = torch.empty((b, c, c), **f32)
    o = torch.empty((b, h, w, c), **f32)
    y = torch.empty_like(o)
    u = torch.empty((b, h, w, 2 * f), **f32)
    g = torch.empty((b, h, w, f), **f32)
    z = torch.empty_like(x)
    weights = torch_layout(params)
    err = getattr(lib, _ENTRY[x.dtype])(
        x.data_ptr(), *(p.data_ptr() for p in weights), z.data_ptr(),
        *(s.data_ptr() for s in (t, qkv, part, red, attn, o, y, u, g)),
        b, h, w, c, f, heads, int(use_softmax), int(ln_bias), eps, stream)
    if err != 0:
        raise RuntimeError(f"mdta_block kernel launch failed with CUDA error {err}")
    if not residuals:
        return z
    stats = (red[:, : c * ch].reshape(b, c, ch).contiguous(), red[:, c * ch: c * ch + c].contiguous(),
             red[:, c * ch + c:].contiguous())
    return z, (*stats, attn, t, qkv, o, y, u, g)


def _kernel_forward(x, params, heads: int, use_softmax: bool, ln_bias: bool, eps: float, residuals: bool = False):
    """Check the inputs, count the launch and run K6 on x's device and current stream."""
    _check(x, params, heads)
    mdta_block_fused.launches += 1
    with torch.cuda.device(x.device):
        return _launch(_lib(), x, params, heads, use_softmax, ln_bias, eps, torch.cuda.current_stream().cuda_stream,
                       residuals)


class MDTABlockFunction(torch.autograd.Function):
    """The TransformerBlock with its analytic backward (dcpt_tpu's ``custom_vjp``), fp32 or bf16.

    ``apply(x, heads, use_softmax, ln_bias, eps, *params)``; on the card the
    forward is K6 keeping its residuals and the backward K7, on the CPU both
    are the plain versions."""

    @staticmethod
    def forward(ctx, x, heads, use_softmax, ln_bias, eps, *params):
        if x.device.type == "cpu":
            z, res = _ref_forward(x, *params, heads, use_softmax, ln_bias, eps)
        else:
            z, res = _kernel_forward(x, list(params), heads, use_softmax, ln_bias, eps, residuals=True)
        ctx.config = (heads, use_softmax, ln_bias, eps)
        ctx.save_for_backward(x, *params, *res)
        return z

    @staticmethod
    def backward(ctx, dz):
        from .mdta_block_bwd import mdta_block_bwd

        x, *saved = ctx.saved_tensors
        grads = mdta_block_bwd(x, *saved[:11], dz.contiguous(), tuple(saved[11:]), *ctx.config)
        return (grads[0], None, None, None, None, *grads[1:])


def mdta_block_fused(x, n1w, n1b, wqkv, wdwq, temperature, wproj, n2w, n2b, win_, wdwf, wout,
                     heads: int, use_softmax: bool, ln_bias: bool, eps: float = 1e-6):
    """The whole TransformerBlock over (B, H, W, C): the CUDA kernel on a CUDA
    tensor, the plain version on a CPU tensor."""
    params = [n1w, n1b, wqkv, wdwq, temperature, wproj, n2w, n2b, win_, wdwf, wout]
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"mdta_block_fused: no kernel for device {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or any(p.requires_grad for p in params)):
        return MDTABlockFunction.apply(x, heads, use_softmax, ln_bias, eps, *params)
    if x.device.type == "cpu":
        return mdta_block_ref(x, *params, heads, use_softmax, ln_bias, eps)
    return _kernel_forward(x, params, heads, use_softmax, ln_bias, eps)


mdta_block_fused.launches = 0
