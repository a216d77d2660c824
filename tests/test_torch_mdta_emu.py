"""K6's and K7's CUDA sources (``csrc/mdta_block.cu``, ``csrc/mdta_block_bwd.cu``)
built for the CPU by the port's CUDA emulation (``dcpt_tpu_torch.tools.cuda_emu``),
against their plain versions: runs their indexing, masking and fixed-order
sums here."""

import ctypes
import shutil

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401
from dcpt_tpu_torch.ops import mdta_block as mb
from dcpt_tpu_torch.ops import mdta_block_bwd as mbb
from dcpt_tpu_torch.tools.cuda_emu import build as emu

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="the CUDA emulation compiles with g++")


@pytest.fixture(scope="module")
def k6_lib(tmp_path_factory):
    return mb._bind(ctypes.CDLL(str(emu.build("mdta_block.cu", tmp_path_factory.mktemp("cuda_emu_k6")))))


def _block_inputs(b, h, w, c, heads, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    f = int(c * 2.66)

    def r(*shape, scale=0.3, shift=0.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale + shift).astype(np.float32)).to(dtype)

    return r(b, h, w, c, scale=1.0), [r(c, shift=1.0), r(c), r(c, 3 * c, scale=c ** -0.5), r(3, 3, 3 * c, scale=1 / 3),
                                      r(heads, 1, 1, shift=1.0), r(c, c, scale=c ** -0.5), r(c, shift=1.0), r(c),
                                      r(c, 2 * f, scale=c ** -0.5), r(3, 3, 2 * f, scale=1 / 3),
                                      r(f, c, scale=f ** -0.5)]


# (B, H, W, C, heads): ragged rows and columns with three heads; a 1 x 1 map;
# C = 70 (two 64-wide column blocks and a two-tile Gram); 300 pixels (three Gram chunks)
@pytest.mark.parametrize("b,h,w,c,heads", [(2, 5, 7, 12, 3), (1, 1, 1, 8, 2), (1, 4, 4, 70, 1), (1, 15, 20, 24, 2)])
@pytest.mark.parametrize("use_softmax,ln_bias,eps", [(False, False, 1e-6), (True, True, 1e-5)])
def test_mdta_block_emulated_vs_plain(k6_lib, b, h, w, c, heads, use_softmax, ln_bias, eps):
    """z within 1e-5 of max(1, max|ref|); the residuals (v, the head blocks of the
    Gram, the squared norms, attn) against the plain computation."""
    x, params = _block_inputs(b, h, w, c, heads, seed=c + h)
    z, (gram, qn2, kn2, attn, _, qkv, *_) = mb._launch(k6_lib, x, params, heads, use_softmax, ln_bias, eps, 0,
                                                       residuals=True)
    v = qkv[..., 2 * c:]
    ref = mb.mdta_block_ref(x, *params, heads, use_softmax, ln_bias, eps)
    torch.testing.assert_close(z, ref, atol=1e-5 * max(1.0, ref.abs().max().item()), rtol=0)
    ln1 = mb.ln_channel(x.reshape(-1, c), params[0], params[1], eps, ln_bias).reshape(x.shape)
    q, k, v_ref = mb._dwconv(ln1 @ params[2], params[3]).reshape(b, h * w, 3 * c).split(c, dim=-1)
    full = torch.einsum("bpc,bpd->bcd", q, k)
    ch = c // heads
    blocks = torch.cat([full[:, i * ch:(i + 1) * ch, i * ch:(i + 1) * ch] for i in range(heads)], dim=1)
    torch.testing.assert_close(v.reshape(v_ref.shape), v_ref, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(gram, blocks, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(qn2, (q * q).sum(1), atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(kn2, (k * k).sum(1), atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(attn, mb.attn_from_stats(full, (q * q).sum(1), (k * k).sum(1), params[4], heads,
                                                        use_softmax), atol=1e-5, rtol=1e-5)


def test_mdta_block_emulated_bf16(k6_lib):
    """bf16 I/O with fp32 math, against the plain version in fp32 on the same rounded inputs."""
    x, params = _block_inputs(1, 6, 5, 16, 2, seed=1, dtype=torch.bfloat16)
    z = mb._launch(k6_lib, x, params, 2, True, True, 1e-5, 0)
    ref = mb.mdta_block_ref(x.float(), *[p.float() for p in params], 2, True, True, 1e-5)
    assert z.dtype == torch.bfloat16
    assert (z.float() - ref).abs().max().item() <= 2e-2 * max(1.0, ref.abs().max().item())


@pytest.fixture(scope="module")
def k7_lib(tmp_path_factory):
    return mbb._bind(ctypes.CDLL(str(emu.build("mdta_block_bwd.cu", tmp_path_factory.mktemp("cuda_emu_k7")))))


def test_mdta_block_bwd_emulated_vs_plain(k6_lib, k7_lib):
    """K7 from K6's residuals (softmax, WithBias) on one tile of pixels, a 4 x 4
    map with two 8-wide heads (ragged columns in every product: F = 42), kept
    to one tile because the emulation runs a thread per CUDA thread: all 12
    cotangents within 1e-5 of max(1, max|ref|).  The ReLU / BiasFree flavour,
    ragged maps and the multi-chunk dattn, tap and weight-gradient sums run on
    the card (tests/test_torch_cuda.py, chip_smoke.py [10])."""
    x, params = _block_inputs(1, 4, 4, 16, 2, seed=7)
    dz = torch.from_numpy(np.random.default_rng(8).standard_normal(x.shape).astype(np.float32))
    _, res = mb._launch(k6_lib, x, params, 2, True, True, 1e-5, 0, residuals=True)
    got = mbb._launch(k7_lib, x, params, dz, res, 2, True, True, 1e-5, 0)
    ref = mbb.mdta_block_bwd_ref(x, *params, *res[:4], dz, 2, True, True, 1e-5)
    for i, (a, r) in enumerate(zip(got, ref)):
        assert a.shape == r.shape, i
        torch.testing.assert_close(a, r, atol=1e-5 * max(1.0, r.abs().max().item()), rtol=0, msg=f"cotangent {i}")
