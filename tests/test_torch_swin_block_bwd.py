"""The Swin block backward of the PyTorch port (K9's plain version, its CUDA
source under the CPU emulation, and the two autograd routes of SwinIR's
blocks) against dcpt_tpu, on the CPU.

Shapes are tiny: C 12, 2 heads, 4 x 4 windows, hidden 24, an 8 x 8 map shifted
by 2, so every window but one straddles the image seam.  dcpt_tpu's Pallas
kernels run in interpret mode on the rolled, partitioned windows; the port
works on the map.  Limits are relative to max(1, max|ref|) of each cotangent.
"""

import ctypes
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _torch_threads  # noqa: F401
from dcpt_tpu.archs.swinir_arch import window_partition as jax_partition
from dcpt_tpu.archs.swinir_arch import window_reverse as jax_reverse
from dcpt_tpu.ops import window_attention as jwa
from dcpt_tpu.ops.swin_block_bwd import pick_bwd_tile
from dcpt_tpu.ops.swin_block_bwd import swin_block_bwd as jax_swin_block_bwd
from dcpt_tpu_torch.ops import swin_block_bwd as sbb
from dcpt_tpu_torch.ops import window_attention as wa
from dcpt_tpu_torch.tools.cuda_emu import build as emu

C, HEADS, WS, HIDDEN = 12, 2, 4, 24
NAMES = ["dx", "dln1_w", "dln1_b", "dwqkv", "dbqkv", "dwproj", "dbproj", "dln2_w", "dln2_b", "dwfc1", "dbfc1",
         "dwfc2", "dbfc2"]


def _inputs(seed, shape=(1, 8, 8, C), c=C, hidden=HIDDEN):
    """x, dz and the 12 block parameters in the op's (in, out) layout, as numpy."""
    rng = np.random.default_rng(seed)

    def r(*s, scale=0.3, shift=0.0):
        return (rng.standard_normal(s) * scale + shift).astype(np.float32)

    params = [r(c, shift=1.0), r(c), r(c, 3 * c, scale=c ** -0.5), r(3 * c), r(c, c, scale=c ** -0.5), r(c),
              r(c, shift=1.0), r(c), r(c, hidden, scale=c ** -0.5), r(hidden), r(hidden, c, scale=hidden ** -0.5),
              r(c)]
    return r(*shape, scale=1.0), r(*shape, scale=1.0), params


def _windows(t, shift):
    return jax_partition(jnp.roll(jnp.asarray(t), (-shift, -shift), axis=(1, 2)), WS)


def _unwindow(t, h, w, shift):
    return np.asarray(jnp.roll(jax_reverse(t, WS, h, w), (shift, shift), axis=(1, 2)))


def _assert_cotangents(got, want, limit, names=NAMES):
    for name, g, w in zip(names, got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, (name, g.shape, w.shape)
        np.testing.assert_allclose(g, w, rtol=0, atol=limit * max(1.0, np.abs(w).max()), err_msg=name)


@pytest.mark.parametrize("jax_side", ["pallas_interpret", "jax_vjp"])
def test_ref_matches_dcpt_tpu(jax_side):
    """All 13 cotangents of ``swin_block_bwd_ref`` on the map within 1e-5 of
    dcpt_tpu's K9 (interpret mode) or of ``jax.vjp(swin_block_ref)``, both on
    the same rolled windows; dx comes back through reverse and roll."""
    shift = 2
    x, dz, params = _inputs(40)
    ours = sbb.swin_block_bwd_ref(torch.from_numpy(x), *map(torch.from_numpy, params), torch.from_numpy(dz), HEADS,
                                  WS, shift)
    xw, dzw = _windows(x, shift), _windows(dz, shift)
    jp = [jnp.asarray(p) for p in params]
    if jax_side == "pallas_interpret":
        t = pick_bwd_tile(xw.shape[0], WS * WS, C, HIDDEN, HEADS)
        theirs = jax_swin_block_bwd(xw, *jp, dzw, HEADS, 1e-5, t, interpret=True)
    else:
        _, vjp = jax.vjp(lambda *a: jwa.swin_block_ref(*a, HEADS, 1e-5), xw, *jp)
        theirs = vjp(dzw)
    theirs = [_unwindow(theirs[0], 8, 8, shift), *theirs[1:]]
    _assert_cotangents([t.numpy() for t in ours], theirs, 1e-5)


@pytest.mark.parametrize("shift", [0, 2])
def test_swin_block_function_cpu_grads(shift):
    """``fused_swin_block`` under autograd on the CPU runs ``SwinBlockFunction``
    (the plain forward, K9's plain version as its backward): output and all 13
    gradients within 1e-5 of autograd through ``swin_block_map_ref``."""
    x, dz, params = _inputs(41 + shift, shape=(2, 8, 12, C))
    leaves = [torch.from_numpy(t).requires_grad_() for t in [x, *params]]
    z = wa.fused_swin_block(*leaves, HEADS, WS, shift)
    assert type(z.grad_fn).__name__ == "SwinBlockFunctionBackward"
    got = torch.autograd.grad(z, leaves, torch.from_numpy(dz))
    ref_leaves = [torch.from_numpy(t).double().requires_grad_() for t in [x, *params]]
    ref = wa.swin_block_map_ref(*ref_leaves, HEADS, WS, shift)
    want = torch.autograd.grad(ref, ref_leaves, torch.from_numpy(dz).double())
    _assert_cotangents([z.detach().numpy()], [ref.detach().numpy()], 1e-5, ["z"])
    _assert_cotangents([g.numpy() for g in got], [w.float().numpy() for w in want], 1e-5)


@pytest.mark.parametrize("with_ln", [True, False])
def test_k10_route_grads_match_dcpt_tpu(with_ln):
    """The ``DCPT_TPU_SWIN_BLOCK=0`` route under autograd (``WindowAttentionFunction``):
    the output and the gradients of x and of every parameter it takes within
    1e-5 of dcpt_tpu's custom VJP of ``fused_window_attention(_ln)`` (which
    differentiates its twin), on two 8 x 12 maps shifted by 2."""
    shift = 2
    x, dz, params = _inputs(43 + with_ln, shape=(2, 8, 12, C))
    attn = params[2:6]
    taken = ([params[0], params[1]] if with_ln else []) + attn
    leaves = [torch.from_numpy(t).requires_grad_() for t in [x, *taken]]
    if with_ln:
        out = wa.fused_window_attention_ln(leaves[0], *leaves[1:], HEADS, WS, shift)
        fn = lambda t, lw, lb, *a: jwa.fused_window_attention_ln(t, lw, lb, *a, HEADS, 1e-5, True)  # noqa: E731
    else:
        out = wa.fused_window_attention(*leaves, HEADS, WS, shift)
        fn = lambda t, *a: jwa.fused_window_attention(t, *a, HEADS, True)  # noqa: E731
    assert type(out.grad_fn).__name__ == "WindowAttentionFunctionBackward"
    got = torch.autograd.grad(out, leaves, torch.from_numpy(dz))
    ref, vjp = jax.vjp(fn, _windows(x, shift), *map(jnp.asarray, taken))
    want = vjp(_windows(dz, shift))
    names = ["dx", *(["dln1_w", "dln1_b"] if with_ln else []), "dwqkv", "dbqkv", "dwproj", "dbproj"]
    _assert_cotangents([out.detach().numpy()], [_unwindow(ref, 8, 12, shift)], 1e-5, ["out"])
    _assert_cotangents([g.numpy() for g in got], [_unwindow(want[0], 8, 12, shift), *want[1:]], 1e-5, names)


@pytest.fixture(scope="module")
def k9_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("the CUDA emulation compiles with g++")
    return sbb._bind(ctypes.CDLL(str(emu.build("swin_block_bwd.cu", tmp_path_factory.mktemp("cuda_emu_k9")))))


# (B, H, W, heads, ws, shift): the 8 x 8 map across the seam; two images of 8 x 16 with 3
# heads in one 8 x 8 window a row, shifted by 4; 8 x 20 = 160 tokens, two token tiles of the
# tensor-core products (96 tokens), the second ragged; and that map with bf16 I/O
@pytest.mark.parametrize("b,h,w,heads,ws,shift,dtype", [(1, 8, 8, 2, 4, 2, torch.float32),
                                                        (2, 8, 16, 3, 8, 4, torch.float32),
                                                        (1, 8, 20, 2, 4, 2, torch.float32),
                                                        (1, 8, 20, 2, 4, 2, torch.bfloat16)])
def test_k9_emulated_vs_plain(k9_lib, b, h, w, heads, ws, shift, dtype):
    """K9's CUDA source (``csrc/swin_block_bwd.cu``) built for the CPU by the
    port's CUDA emulation: all 13 cotangents within 1e-5 (fp32) or 2e-2 (bf16 x,
    dz and parameters, bf16 cotangents) of max(1, max|ref|) of the plain version."""
    x, dz, params = _inputs(45 + shift, shape=(b, h, w, C))
    tx, tdz, tp = (torch.from_numpy(x).to(dtype), torch.from_numpy(dz).to(dtype),
                   [torch.from_numpy(p).to(dtype) for p in params])
    got = sbb._launch(k9_lib, tx, tp, tdz, heads, ws, shift, 1e-5, 0)
    want = sbb.swin_block_bwd_ref(tx, *tp, tdz, heads, ws, shift)
    assert all(g.dtype == dtype for g in got)
    _assert_cotangents([g.float().numpy() for g in got], [t.float().numpy() for t in want],
                       1e-5 if dtype == torch.float32 else 2e-2)


@pytest.mark.parametrize("block_kernel", [True, False])
def test_swinir_routes_reach_the_functions(monkeypatch, block_kernel):
    """Under autograd every SwinTransformerBlock of a tiny SwinIR runs through
    ``SwinBlockFunction`` (the K8 route), or with ``DCPT_TPU_SWIN_BLOCK=0``
    through ``WindowAttentionFunction`` (the K10 route), and the net's
    gradients are within 1e-5 of autograd through the plain block."""
    from dcpt_tpu_torch.archs import swinir_arch

    torch.manual_seed(0)
    net = swinir_arch.SwinIR(embed_dim=12, depths=[2, 2], num_heads=[2, 2], window_size=8)
    x = torch.rand(1, 3, 16, 24, generator=torch.Generator().manual_seed(1))
    calls = {"SwinBlockFunction": 0, "WindowAttentionFunction": 0}
    for fn in (wa.SwinBlockFunction, wa.WindowAttentionFunction):
        monkeypatch.setattr(fn, "forward", staticmethod(
            lambda ctx, *a, _f=fn.forward, _n=fn.__name__: calls.update({_n: calls[_n] + 1}) or _f(ctx, *a)))

    def grads():
        net.zero_grad()
        net(x)[0].square().mean().backward()
        return [p.grad.clone() for p in net.parameters()]

    monkeypatch.setattr(swinir_arch, "SWIN_BLOCK_KERNEL", block_kernel)
    got = grads()
    assert calls == {"SwinBlockFunction": 4 * block_kernel, "WindowAttentionFunction": 4 * (not block_kernel)}
    monkeypatch.setattr(swinir_arch.SwinTransformerBlock, "forward", lambda self, t: wa.swin_block_map_ref(
        t, *self.op_args(), self.num_heads, self.window_size, self.shift_size))
    for a, b in zip(got, grads()):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * max(1.0, b.abs().max().item()))
