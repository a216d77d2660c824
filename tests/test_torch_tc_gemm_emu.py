"""The tensor-core product of the port's kernels (``csrc/tc_gemm.cuh``) alone, through
``csrc/tc_gemm_probe.cu`` built for the CPU by the port's CUDA emulation
(``dcpt_tpu_torch.tools.cuda_emu``, whose ``mma.sync`` takes TF32 operands and
sums exactly), against numpy in float64: both layouts of a weight, ragged
depths and widths (16-byte ``cp.async`` units and, where a row is not so
aligned, plain loads), fp32 and bf16 operands, and a weight gradient cut
along the tokens with its bias sums."""

import ctypes
import shutil

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401
from dcpt_tpu_torch.tools.cuda_emu import build as emu

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="the CUDA emulation compiles with g++")

# 3xTF32 keeps about 2^-21 of each product, the fp32 sums over the depth about 2^-24 a
# term: 1e-5 of max(1, max|ref|) over depths of at most 300
LIMIT = 1e-5


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    lib = ctypes.CDLL(str(emu.build("tc_gemm_probe.cu", tmp_path_factory.mktemp("cuda_emu_tc"))))
    lib.tc_gemm_probe.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.tc_wgrad_probe.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.tc_depth_chunks.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    return lib


def _close(got: torch.Tensor, want: np.ndarray) -> None:
    assert tuple(got.shape) == want.shape
    err = np.abs(got.double().numpy() - want).max()
    assert err <= LIMIT * max(1.0, np.abs(want).max()), err


# (T, K, N): a ragged token tile, depth and width in 4-element units (cp.async); K = 21
# and N = 30, rows that are no multiple of 4 elements (plain loads)
@pytest.mark.parametrize("t,k,n", [(100, 36, 116), (50, 21, 30)])
@pytest.mark.parametrize("wt", [False, True], ids=["a.W^T", "a.W"])
@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
def test_product_emulated_vs_float64(lib, t, k, n, wt, w_dtype):
    """out (T, N) = a (T, K) . W^T with W (N, K), or a . W with W (K, N); fp32 a,
    fp32 or bf16 W (two MMAs a step for bf16, three for fp32)."""
    rng = np.random.default_rng(t + k + n + wt)
    a = torch.from_numpy(rng.standard_normal((t, k)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((k, n) if wt else (n, k)).astype(np.float32)).to(w_dtype)
    out = torch.full((t, n), float("nan"))
    assert lib.tc_gemm_probe(a.data_ptr(), w.data_ptr(), out.data_ptr(), t, k, n, int(wt),
                             int(w_dtype == torch.bfloat16), None) == 0
    w64 = w.double().numpy()
    _close(out, a.double().numpy() @ (w64 if wt else w64.T))


# (T, M, N): 300 tokens in chunks of 32 (one tile each), widths in 4-element units; M = 21
# and N = 30 by plain loads
@pytest.mark.parametrize("t,m,n,a_dtype", [(300, 20, 36, torch.float32), (300, 20, 36, torch.bfloat16),
                                           (300, 21, 30, torch.float32), (300, 21, 30, torch.bfloat16)])
def test_weight_gradient_emulated_vs_float64(lib, t, m, n, a_dtype):
    """part[z] (M, N) = sum over chunk z's tokens of a[p]^T b[p] and sums[z] (M,) of
    a[p], chunks of a multiple of 32 tokens; their sums over z against numpy."""
    rng = np.random.default_rng(t + m + n)
    a = torch.from_numpy(rng.standard_normal((t, m)).astype(np.float32)).to(a_dtype)
    b = torch.from_numpy(rng.standard_normal((t, n)).astype(np.float32))
    length = ctypes.c_int()
    chunks = lib.tc_depth_chunks(m, n, t, ctypes.byref(length))
    assert chunks > 1 and length.value % 32 == 0 and (chunks - 1) * length.value < t <= chunks * length.value
    part, sums = torch.full((chunks, m, n), float("nan")), torch.full((chunks, m), float("nan"))
    assert lib.tc_wgrad_probe(a.data_ptr(), b.data_ptr(), part.data_ptr(), sums.data_ptr(), t, m, n,
                              int(a_dtype == torch.bfloat16), None) == 0
    a64 = a.double().numpy()
    _close(part.double().sum(0), a64.T @ b.double().numpy())
    _close(sums.double().sum(0), a64.sum(0))
