"""K8's and K10's CUDA sources (``csrc/swin_block.cu``, ``csrc/window_attention.cu``)
built for the CPU by the port's CUDA emulation (``dcpt_tpu_torch.tools.cuda_emu``),
against their map-level plain versions: runs the window index map, the
shifted windows across the seam, the zero-padded ragged widths and the
tensor-core products here, before a chip call; and the emulated PTX
(``csrc/ptx.cuh``: TF32 rounding, the m16n8k8 MMA) against numpy.  (Beside
``tests/test_torch_cuda_emu.py`` and ``tests/test_torch_mdta_emu.py``, which check K3, K6
and K7 the same way.)"""

import ctypes
import shutil

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401
from dcpt_tpu_torch.ops import swin_block_bwd as tsbb
from dcpt_tpu_torch.ops import window_attention as twa
from dcpt_tpu_torch.tools.cuda_emu import build as emu

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="the CUDA emulation compiles with g++")


@pytest.fixture(scope="module")
def swin_libs(tmp_path_factory):
    out = tmp_path_factory.mktemp("cuda_emu_swin")
    return (twa._bind_block(ctypes.CDLL(str(emu.build("swin_block.cu", out)))),
            twa._bind_attn(ctypes.CDLL(str(emu.build("window_attention.cu", out)))))


@pytest.mark.parametrize("kernel", ["K8", "K10 with LN1", "K10"])
def test_swin_kernels_emulated_vs_plain(swin_libs, kernel):
    """C 12, 2 heads, 4 x 4 windows on an 8 x 8 map shifted by 2 (windows across
    the seam), fp32: within 1e-5 of max(1, max|ref|) of the map-level plain version."""
    rng = np.random.default_rng(30)

    def r(*shape, scale=0.3, shift=0.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale + shift).astype(np.float32))

    c, hidden = 12, 24
    x = r(1, 8, 8, c, scale=1.0)
    params = [r(c, shift=1.0), r(c), r(c, 3 * c, scale=c ** -0.5), r(3 * c), r(c, c, scale=c ** -0.5), r(c),
              r(c, shift=1.0), r(c), r(c, hidden, scale=c ** -0.5), r(hidden), r(hidden, c, scale=hidden ** -0.5), r(c)]
    block_lib, attn_lib = swin_libs
    if kernel == "K8":
        got = twa._launch_block(block_lib, x, params, 2, 4, 2, 1e-5, 0)
        ref = twa.swin_block_map_ref(x, *params, 2, 4, 2)
    else:
        ln = (params[0], params[1], 1e-5) if kernel == "K10 with LN1" else None
        got = twa._launch_attn(attn_lib, x, params[2:6], 2, 4, 2, ln, 0)
        ref = twa.window_attention_map_ref(x, *params[2:6], 2, 4, 2, ln)
    torch.testing.assert_close(got, ref, atol=1e-5 * max(1.0, ref.abs().max().item()), rtol=0)


def _tf32_rna(x: np.ndarray) -> np.ndarray:
    """fp32 -> TF32 by its definition: the nearer of the two TF32 values around |x|
    (10 mantissa bits), a tie to the larger magnitude; computed in float64."""
    mag = np.abs(x).astype(np.float32)
    down = (mag.view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32).astype(np.float64)
    step = np.spacing(down.astype(np.float32)).astype(np.float64) * 2.0 ** 13  # a TF32 ulp at |x| (normal |x|)
    up = mag.astype(np.float64) - down >= step / 2
    return (np.sign(x) * np.where(up, down + step, down)).astype(np.float32)


def test_ptx_emulation_vs_numpy(tmp_path):
    """``csrc/ptx_probe.cu`` under the emulation: one warp's m16n8k8 TF32 MMA in
    the PTX ISA's fragment layout equals numpy's A B + C on TF32 operands bit
    for bit (products and sums exact in float64, rounded once), and tf32_round
    is round to nearest, ties away from zero, on the 13 dropped bits."""
    lib = ctypes.CDLL(str(emu.build("ptx_probe.cu", tmp_path)))
    lib.ptx_probe.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_void_p]
    rng = np.random.default_rng(31)
    a = _tf32_rna(rng.standard_normal((16, 8)).astype(np.float32))
    b = _tf32_rna(rng.standard_normal((8, 8)).astype(np.float32))
    c = rng.standard_normal((16, 8)).astype(np.float32)
    # random values, exact ties either way (dropped bits 0x1000), both signs, and just below a binade
    bits = rng.integers(0x3F000000, 0x41000000, 64, dtype=np.uint32)
    ties = (bits[:16] & np.uint32(0xFFFFE000)) | np.uint32(0x1000)
    x = np.concatenate([rng.standard_normal(64).astype(np.float32), ties.view(np.float32),
                        -ties.view(np.float32), np.float32([1.9999999, -0.99999994, 0.0, 3e-5])])
    d, rounded = np.zeros((16, 8), np.float32), np.zeros_like(x)
    assert lib.ptx_probe(a.ctypes.data, b.ctypes.data, c.ctypes.data, d.ctypes.data, x.ctypes.data,
                         rounded.ctypes.data, x.size, None) == 0
    np.testing.assert_array_equal(rounded, _tf32_rna(x))
    np.testing.assert_array_equal(d, (a.astype(np.float64) @ b.astype(np.float64) + c).astype(np.float32))


def _swin_case(rng, b, h, w, c, hidden):
    def r(*shape, scale=0.3, shift=0.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale + shift).astype(np.float32))

    return r(b, h, w, c, scale=1.0), [r(c, shift=1.0), r(c), r(c, 3 * c, scale=c ** -0.5), r(3 * c),
                                      r(c, c, scale=c ** -0.5), r(c), r(c, shift=1.0), r(c),
                                      r(c, hidden, scale=c ** -0.5), r(hidden), r(hidden, c, scale=hidden ** -0.5),
                                      r(c)]


@pytest.mark.parametrize("kernel", ["K8", "K10 with LN1", "K10"])
def test_swin_kernels_emulated_ragged_widths(swin_libs, kernel):
    """C 36, 3 heads of 12 (a pass of two heads, then one), hidden 72, full 8 x 8
    windows on a 16 x 16 map shifted by 4, fp32: no width a multiple of 8, all
    zero-padded in shared memory and the weight chunks; within 1e-5 of
    max(1, max|ref|) of the map-level plain version."""
    x, params = _swin_case(np.random.default_rng(32), 1, 16, 16, 36, 72)
    block_lib, attn_lib = swin_libs
    if kernel == "K8":
        got = twa._launch_block(block_lib, x, params, 3, 8, 4, 1e-5, 0)
        ref = twa.swin_block_map_ref(x, *params, 3, 8, 4)
    else:
        ln = (params[0], params[1], 1e-5) if kernel == "K10 with LN1" else None
        got = twa._launch_attn(attn_lib, x, params[2:6], 3, 8, 4, ln, 0)
        ref = twa.window_attention_map_ref(x, *params[2:6], 3, 8, 4, ln)
    torch.testing.assert_close(got, ref, atol=1e-5 * max(1.0, ref.abs().max().item()), rtol=0)


def test_swin_block_emulated_bf16(swin_libs):
    """bf16 I/O (two MMAs a weight product), C 30 (rows of 60 bytes: the weights
    staged by plain loads, not cp.async), 3 heads of 10, hidden 60, 8 x 8
    windows on a 16 x 8 map shifted by 4: K8 within 2e-2 of max(1, max|ref|) of
    the plain version in fp32 on the same bf16 values, and closer than the
    output's own bf16 rounding allows plus the same again."""
    x, params = _swin_case(np.random.default_rng(33), 1, 16, 8, 30, 60)
    x, params = x.bfloat16(), [p.bfloat16() for p in params]
    got = twa._launch_block(swin_libs[0], x, params, 3, 8, 4, 1e-5, 0)
    ref = twa.swin_block_map_ref(x.float(), *[p.float() for p in params], 3, 8, 4)
    assert got.dtype == torch.bfloat16
    scale = max(1.0, ref.abs().max().item())
    err = (got.float() - ref).abs().max().item()
    assert err <= 2e-2 * scale
    assert err <= 2 * 2.0 ** -8 * ref.abs().max().item()


def test_k9_emulated_wide_heads(tmp_path):
    """K9 (``csrc/swin_block_bwd.cu``) with two heads of 40 (C 80, hidden 96):
    the window passes' layout for heads of 33 to 64 channels (eight 8-wide
    tiles a head), on an 8 x 16 map shifted by 4, fp32; all 13 cotangents within
    1e-5 of max(1, max|ref|) of the plain version."""
    lib = tsbb._bind(ctypes.CDLL(str(emu.build("swin_block_bwd.cu", tmp_path))))
    x, params = _swin_case(np.random.default_rng(35), 1, 8, 16, 80, 96)
    dz = torch.from_numpy(np.random.default_rng(36).standard_normal(x.shape).astype(np.float32))
    got = tsbb._launch(lib, x, params, dz, 2, 8, 4, 1e-5, 0)
    for i, (g, r) in enumerate(zip(got, tsbb.swin_block_bwd_ref(x, *params, dz, 2, 8, 4))):
        assert g.shape == r.shape, i
        torch.testing.assert_close(g, r, atol=1e-5 * max(1.0, r.abs().max().item()), rtol=0, msg=f"cotangent {i}")

