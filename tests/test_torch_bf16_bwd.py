"""The TransformerBlock and Swin block backwards of the PyTorch port in bf16, on the CPU.

Mixed-precision training runs K7 (``ops/mdta_block_bwd.py``) and K9
(``ops/swin_block_bwd.py``) on bf16 inputs: both compute in fp32 and return
each cotangent in its primal's dtype, as dcpt_tpu's kernels do.  Here:

* their plain versions on bf16 inputs against dcpt_tpu's Pallas kernels run in
  interpret mode on the same bf16 inputs (K7 given the residuals of dcpt_tpu's
  bf16 forward kernel), as ``test_torch_mdta_block_bwd.py`` and
  ``test_torch_swin_block_bwd.py`` hold them in fp32;
* K6's, K7's and K9's CUDA sources built for the CPU by the port's CUDA
  emulation (``dcpt_tpu_torch.tools.cuda_emu``) in bf16 against the plain
  versions, and K6's bf16 entry against its fp32 entry on the same values:
  the fp32 residuals K7 reads are the same bits.

Every cotangent within 2e-2 of max(1, max|ref|), in its primal's dtype.
"""

import ctypes
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import _torch_threads  # noqa: F401
from dcpt_tpu.ops.mdta_block import _block_pallas as jax_block_pallas
from dcpt_tpu.ops.mdta_block_bwd import mdta_block_bwd as jax_mdta_block_bwd
from dcpt_tpu.ops.swin_block_bwd import pick_bwd_tile
from dcpt_tpu.ops.swin_block_bwd import swin_block_bwd as jax_swin_block_bwd
from dcpt_tpu_torch.ops import mdta_block as mb
from dcpt_tpu_torch.ops import mdta_block_bwd as mbb
from dcpt_tpu_torch.ops import swin_block_bwd as sbb
from dcpt_tpu_torch.tools.cuda_emu import build as emu
from test_torch_mdta_emu import _block_inputs
from test_torch_mdta_block import FLAVOURS, HEADS, block_inputs
from test_torch_swin_block_bwd import C, HIDDEN, WS, _inputs, _unwindow, _windows

TOL = 2e-2


def _bf16(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16()


def _jax(t: torch.Tensor):
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


def _assert_close(got, want, n):
    """``got`` (tensors) against ``want`` (tensors or arrays): same shapes, every
    cotangent in bf16 and within TOL of max(1, max|want|)."""
    assert len(got) == len(want) == n
    for i, (g, w) in enumerate(zip(got, want)):
        w = torch.from_numpy(np.array(w, np.float32)) if not isinstance(w, torch.Tensor) else w.float()
        assert g.dtype == torch.bfloat16 and tuple(g.shape) == tuple(w.shape), (i, g.dtype, g.shape, w.shape)
        err = (g.float() - w).abs().max().item()
        assert err <= TOL * max(1.0, w.abs().max().item()), (i, err, w.abs().max().item())


@pytest.mark.parametrize("flavour", FLAVOURS, ids=["relu_biasfree", "softmax_withbias"])
def test_k7_plain_bf16_matches_dcpt_tpu_kernel(flavour):
    """C = 12, 3 heads, a 16 x 8 map in two of dcpt_tpu's row tiles: bf16 x, dz and
    parameters, the residuals of dcpt_tpu's bf16 forward kernel."""
    x, params = block_inputs(2, 16, 8, seed=21)
    dz = np.random.default_rng(22).standard_normal(x.shape).astype(np.float32)
    xt, pt, dzt = _bf16(x), [_bf16(p) for p in params], _bf16(dz)
    jx = [_jax(t) for t in (xt, *pt)]
    _, v, gram, qn2, kn2, attn = jax_block_pallas(*jx, HEADS, *flavour, 8, True, None, with_res=True)
    theirs = jax_mdta_block_bwd(*jx, v, gram, qn2, kn2, attn, _jax(dzt), HEADS, *flavour, 8, interpret=True)
    assert all(t.dtype == jnp.bfloat16 for t in theirs)
    gram, qn2, kn2, attn = (torch.from_numpy(np.array(r, np.float32)) for r in (gram, qn2, kn2, attn))
    ours = mbb.mdta_block_bwd_ref(xt, *pt, mb.head_blocks(gram, HEADS), qn2, kn2, attn, dzt, HEADS, *flavour)
    _assert_close(ours, theirs, 12)


@pytest.mark.parametrize("shift", [0, 2])
def test_k9_plain_bf16_matches_dcpt_tpu_kernel(shift):
    """C 12, 2 heads, 4 x 4 windows on an 8 x 8 map: bf16 x, dz and parameters."""
    x, dz, params = _inputs(60 + shift)
    xt, dzt, pt = _bf16(x), _bf16(dz), [_bf16(p) for p in params]
    ours = sbb.swin_block_bwd_ref(xt, *pt, dzt, 2, WS, shift)
    xw, dzw = _windows(xt.float().numpy(), shift).astype(jnp.bfloat16), _windows(dzt.float().numpy(), shift)
    theirs = jax_swin_block_bwd(xw, *[_jax(p) for p in pt], dzw.astype(jnp.bfloat16), 2, 1e-5,
                                pick_bwd_tile(xw.shape[0], WS * WS, C, HIDDEN, 2), interpret=True)
    assert all(t.dtype == jnp.bfloat16 for t in theirs)
    theirs = [_unwindow(theirs[0].astype(jnp.float32), 8, 8, shift), *theirs[1:]]
    _assert_close(ours, theirs, 13)


def _emu(tmp_path_factory, source, bind):
    if shutil.which("g++") is None:
        pytest.skip("the CUDA emulation compiles with g++")
    return bind(ctypes.CDLL(str(emu.build(source, tmp_path_factory.mktemp("cuda_emu_bf16")))))


@pytest.fixture(scope="module")
def k6_lib(tmp_path_factory):
    return _emu(tmp_path_factory, "mdta_block.cu", mb._bind)


@pytest.fixture(scope="module")
def k7_lib(tmp_path_factory):
    return _emu(tmp_path_factory, "mdta_block_bwd.cu", mbb._bind)


@pytest.fixture(scope="module")
def k9_lib(tmp_path_factory):
    return _emu(tmp_path_factory, "swin_block_bwd.cu", sbb._bind)


# (B, H, W, C, heads): one tile with two 8-wide heads (F = 42); a ragged 3 x 5 map, two images, three heads
@pytest.mark.parametrize("b,h,w,c,heads,flavour", [(1, 4, 4, 16, 2, FLAVOURS[1]), (2, 3, 5, 12, 3, FLAVOURS[0])])
def test_k7_emulated_bf16_vs_plain(k6_lib, k7_lib, b, h, w, c, heads, flavour):
    """bf16 K6 keeps the fp32 residuals its fp32 entry writes for the same values,
    bit for bit; bf16 K7 from them against its plain version."""
    x, params = _block_inputs(b, h, w, c, heads, seed=b + h + c, dtype=torch.bfloat16)
    dz = torch.from_numpy(np.random.default_rng(9).standard_normal(x.shape).astype(np.float32)).bfloat16()
    _, res = mb._launch(k6_lib, x, params, heads, *flavour, 0, residuals=True)
    _, res32 = mb._launch(k6_lib, x.float(), [p.float() for p in params], heads, *flavour, 0, residuals=True)
    assert all(r.dtype == torch.float32 and torch.equal(r, r32) for r, r32 in zip(res, res32))
    got = mbb._launch(k7_lib, x, params, dz, res, heads, *flavour, 0)
    _assert_close(got, mbb.mdta_block_bwd_ref(x, *params, *res[:4], dz, heads, *flavour), 12)


# (B, H, W, heads, ws, shift): the 8 x 8 map across the seam; two 8 x 16 images with 3 heads, shifted by 4
@pytest.mark.parametrize("b,h,w,heads,ws,shift", [(1, 8, 8, 2, 4, 2), (2, 8, 16, 3, 8, 4)])
def test_k9_emulated_bf16_vs_plain(k9_lib, b, h, w, heads, ws, shift):
    x, dz, params = _inputs(70 + shift, shape=(b, h, w, C))
    xt, dzt, pt = _bf16(x), _bf16(dz), [_bf16(p) for p in params]
    got = sbb._launch(k9_lib, xt, pt, dzt, heads, ws, shift, 1e-5, 0)
    _assert_close(got, sbb.swin_block_bwd_ref(xt, *pt, dzt, heads, ws, shift), 13)
