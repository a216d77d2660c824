"""K8's and K10's CUDA sources (``csrc/swin_block.cu``, ``csrc/window_attention.cu``)
built for the CPU by the port's CUDA emulation (``dcpt_tpu_torch.tools.cuda_emu``),
against their map-level plain versions: runs the window index map, the
shifted windows across the seam and the masked ragged widths here, before a
chip call.  (Beside ``tests/test_torch_cuda_emu.py``, which checks K3, K6 and
K7 the same way.)"""

import ctypes
import shutil

import numpy as np
import pytest
import torch

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
