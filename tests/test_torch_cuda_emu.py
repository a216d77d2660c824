"""K3's CUDA source (``csrc/layernorm2d.cu``) built for the CPU by the port's CUDA
emulation (``dcpt_tpu_torch.tools.cuda_emu``), forward and backward against the
plain versions: keeps the emulation working for the sources it is meant to check."""

import ctypes
import shutil

import numpy as np
import pytest
import torch

from dcpt_tpu_torch.ops import layernorm2d as ln
from dcpt_tpu_torch.tools.cuda_emu import build as emu

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="the CUDA emulation compiles with g++")


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return ln._bind(ctypes.CDLL(str(emu.build("layernorm2d.cu", tmp_path_factory.mktemp("cuda_emu")))))


# (20, 512): ragged row blocks, two column blocks; (100, 128): colsum in two passes
@pytest.mark.parametrize("rows,c", [(20, 512), (100, 128)])
def test_layernorm2d_emulated_vs_plain(lib, rows, c):
    rng = np.random.default_rng(rows + c)
    x, g = (torch.from_numpy(rng.standard_normal((rows, c), dtype=np.float32) * 2 + 0.5) for _ in range(2))
    w, b = (torch.from_numpy(rng.standard_normal(c, dtype=np.float32)) for _ in range(2))
    out, y, rsig = ln._launch_fwd(lib, x, w, b, 1e-6, 0, residuals=True)
    primal = ln._launch_fwd(lib, x, w, b, 1e-6, 0, residuals=False)
    grads = ln._launch_bwd(lib, g, y, rsig, w, 0)
    ref_out, ref_y, ref_rsig = ln.layer_norm_2d_ref(x, w, b, 1e-6)
    # fp32 row sums in another order than torch's: 1e-5 absolute on values of order 1-10
    for got, want in [(out, ref_out), (primal, ref_out), (y, ref_y), (rsig, ref_rsig[:, 0])]:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    # gw and gb sum over up to 100 rows
    for got, want in zip(grads, ln.layer_norm_2d_bwd_ref(g, ref_y, ref_rsig, w)):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)
