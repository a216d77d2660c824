"""K3's CUDA source (``csrc/layernorm2d.cu``) built for the CPU by the port's CUDA
emulation (``dcpt_tpu_torch.tools.cuda_emu``), against its plain version: keeps
the emulation working for the sources it is meant to check, and runs K3's
16-byte and 1-element units, rows shared by several warps and the fixed-order
column sums here.  K6's and K7's sources: ``tests/test_torch_mdta_emu.py``."""

import ctypes
import shutil

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401
from dcpt_tpu_torch.ops import layernorm2d as ln
from dcpt_tpu_torch.tools.cuda_emu import build as emu

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="the CUDA emulation compiles with g++")


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return ln._bind(ctypes.CDLL(str(emu.build("layernorm2d.cu", tmp_path_factory.mktemp("cuda_emu")))))


def _rel(a, r):
    return (a.float() - r.float()).abs().max().item() / max(1.0, r.float().abs().max().item())


# (20, 512): 16-byte units, one warp a row, a ragged row block; (100, 128): 13 row
# tiles; (2200, 128): backward blocks that walk two row tiles; (9, 1100): a C that
# is no multiple of 4, 1-element units, four warps a row; bf16 at C = 512 (8
# elements a unit) and at C = 61; rows wider than a block's registers: (6, 4224)
# in 16-byte units, (270, 4100) bf16 in 1-element units with backward blocks
# that take two rows
@pytest.mark.parametrize("rows,c,dtype", [(20, 512, torch.float32), (100, 128, torch.float32),
                                          (2200, 128, torch.float32), (9, 1100, torch.float32),
                                          (20, 512, torch.bfloat16), (30, 61, torch.bfloat16),
                                          (6, 4224, torch.float32), (270, 4100, torch.bfloat16)])
def test_layernorm2d_emulated_vs_plain(lib, rows, c, dtype):
    """fp32: out, mean and 1/sigma within 1e-5, gx within 1e-5 and the column
    sums gw and gb (over up to 2200 rows) within 1e-4 of the plain versions;
    bf16: within 2e-2 relative to max(1, max|ref|), the statistics fp32.  The
    backward twice gives equal bits."""
    rng = np.random.default_rng(rows + c)
    x, g = (torch.from_numpy(rng.standard_normal((rows, c), dtype=np.float32) * 2 + 0.5).to(dtype) for _ in range(2))
    w, b = (torch.from_numpy(rng.standard_normal(c, dtype=np.float32)).to(dtype) for _ in range(2))
    out, mean, rsig = ln._launch_fwd(lib, x, w, b, 1e-6, 0, residuals=True)
    primal = ln._launch_fwd(lib, x, w, b, 1e-6, 0, residuals=False)
    grads = ln._launch_bwd(lib, x, mean, rsig, g, w, 0)
    again = ln._launch_bwd(lib, x, mean, rsig, g, w, 0)
    assert all(torch.equal(a, r) for a, r in zip(grads, again))
    ref_out, ref_y, ref_rsig = ln.layer_norm_2d_ref(x, w, b, 1e-6)
    ref_mean = x.float().mean(-1)
    want = ln.layer_norm_2d_bwd_ref(g, ref_y, ref_rsig, w)
    assert mean.dtype == rsig.dtype == torch.float32 and all(t.dtype == dtype for t in (out, primal, *grads))
    # fp32 row sums in another order than torch's: 1e-5 absolute on values of order 1-10
    for got, ref in [(mean, ref_mean), (rsig, ref_rsig[:, 0])]:
        torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)
    if dtype == torch.bfloat16:
        assert max(_rel(a, r) for a, r in [(out, ref_out), (primal, ref_out), *zip(grads, want)]) <= 2e-2
        return
    for got, ref in [(out, ref_out), (primal, ref_out), (grads[0], want[0])]:
        torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)
    for got, ref in zip(grads[1:], want[1:]):
        torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-5)
