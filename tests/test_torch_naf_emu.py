"""The NAFBlock kernels' CUDA sources built for the CPU by the port's CUDA
emulation (``dcpt_tpu_torch.tools.cuda_emu``), against their plain versions:
K1 (``csrc/naf_block.cu``) and K2 (``csrc/naf_block_bwd.cu``) in fp32 and bf16,
K4 (``csrc/naf_prefix.cu``) and K5 (``csrc/naf_ffn.cu``), which share K1's
passes through ``csrc/naf_common.cuh``, and K3 (``csrc/layernorm2d.cu``) in
bf16.  Ragged tiles and the dwconv's zero border run here; the card runs the
same checks at the real widths (``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import ctypes
import shutil

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401
from dcpt_tpu_torch.ops import layernorm2d as ln
from dcpt_tpu_torch.ops import naf_block as nb
from dcpt_tpu_torch.ops import naf_block_bwd as nbb
from dcpt_tpu_torch.ops import naf_ffn as nff
from dcpt_tpu_torch.ops import naf_prefix as npf
from dcpt_tpu_torch.tools.cuda_emu import build as emu

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="the CUDA emulation compiles with g++")

# fp32: sums in another order than torch's; bf16: the kernel's bf16 output against
# the plain version in fp32 on the same rounded inputs (relative to max(1, max|ref|))
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
BINDINGS = {"naf_block": nb._bind, "naf_block_bwd": nbb._bind, "naf_prefix": npf._bind, "naf_ffn": nff._bind}


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    out = tmp_path_factory.mktemp("cuda_emu_naf")
    return {name: bind(ctypes.CDLL(str(emu.build(name + ".cu", out / name)))) for name, bind in BINDINGS.items()}


def _block(b, h, w, c, seed, dtype):
    """x and the 18 NAFBlock parameters in the op's layout, random affines and residual scales."""
    gen = torch.Generator().manual_seed(seed)

    def r(*shape, scale=0.5, shift=0.0):
        return (torch.randn(*shape, generator=gen) * scale + shift).to(dtype)

    s = c ** -0.5
    return r(b, h, w, c, scale=1.0), [r(c, shift=1.0), r(c), r(c, 2 * c, scale=s), r(2 * c), r(3, 3, 2 * c, scale=1 / 3),
                                      r(2 * c), r(c, c, scale=s), r(c), r(c, c, scale=s), r(c), r(c), r(c, shift=1.0),
                                      r(c), r(c, 2 * c, scale=s), r(2 * c), r(c, c, scale=s), r(c), r(c)]


def _rel(got, ref):
    return ((got.float() - ref.float()).abs().max() / max(1.0, ref.float().abs().max().item())).item()


# (1, 5, 3): one ragged tile, the zero border on every side; (2, 7, 16): two tiles across, two images
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["K1", "K2", "K4", "K5"])
def test_naf_kernels_emulated_vs_plain(libs, kernel, dtype):
    for shape in [(1, 5, 3, 64), (2, 7, 16, 64)]:
        x, p = _block(*shape, seed=sum(shape), dtype=dtype)
        xf, pf = x.float(), [t.float() for t in p]
        if kernel == "K1":
            got, want = nb._launch(libs["naf_block"], x, p, 1e-6, 0), [nb.naf_block_ref(xf, *pf)]
            got = [got]
        elif kernel == "K4":
            got, want = [npf._launch(libs["naf_prefix"], x, p[:6], 1e-6, 0)], [npf.naf_prefix_ref(xf, *pf[:6])]
        elif kernel == "K5":
            got, want = [nff._launch(libs["naf_ffn"], x, p[11:], 1e-6, 0)], [nff.naf_ffn_ref(xf, *pf[11:])]
        else:
            _, (*maps, pooled, att) = nb._launch(libs["naf_block"], x, p, 1e-6, 0, residuals=True)
            dz = _block(*shape, seed=7, dtype=dtype)[0]
            got = nbb._launch(libs["naf_block_bwd"], x, p, pooled, att, dz, maps, 1e-6, 0)
            want = nbb.naf_block_bwd_ref(xf, *pf, pooled, att, dz.float())
        assert all(g.dtype == dtype and g.shape == w.shape for g, w in zip(got, want)), kernel
        worst = max(_rel(g, w) for g, w in zip(got, want))
        assert worst <= TOL[dtype], (kernel, shape, worst)


def test_layernorm2d_bf16_emulated_vs_plain(tmp_path):
    """bf16 x, w, b, out, g and gradients; fp32 statistics (mean and 1/sigma); the
    weight gradients summed in fp32 and cast once (37 rows: a ragged row block)."""
    lib = ln._bind(ctypes.CDLL(str(emu.build("layernorm2d.cu", tmp_path))))
    gen = torch.Generator().manual_seed(3)
    x, g = ((torch.randn(37, 128, generator=gen) * 2 + 0.5).bfloat16() for _ in range(2))
    w, b = (torch.randn(128, generator=gen).bfloat16() for _ in range(2))
    out, mean, rsig = ln._launch_fwd(lib, x, w, b, 1e-6, 0, residuals=True)
    ref_out, ref_y, ref_rsig = ln.layer_norm_2d_ref(x, w, b, 1e-6)
    assert out.dtype == torch.bfloat16 and mean.dtype == rsig.dtype == torch.float32
    assert _rel(out, ref_out) <= TOL[torch.bfloat16]
    torch.testing.assert_close(rsig, ref_rsig[:, 0], atol=1e-5, rtol=1e-5)
    got = ln._launch_bwd(lib, x, mean, rsig, g, w, 0)
    want = ln.layer_norm_2d_bwd_ref(g, ref_y, ref_rsig, w)
    assert all(a.dtype == torch.bfloat16 for a in got)
    assert max(_rel(a, r) for a, r in zip(got, want)) <= TOL[torch.bfloat16]
