"""K14 (``fused_ln_proj``) and K5' (``naf_expand``), the two entries of
``csrc/ln_proj.cu``, whose product runs on the tensor cores through
``csrc/tc_gemm.cuh``'s pieces with the LayerNorm applied as each staged pair
of x is read into an MMA fragment, built for the CPU by the port's CUDA
emulation (``dcpt_tpu_torch.tools.cuda_emu``, whose ``mma.sync`` takes TF32
operands and sums exactly), against their plain versions: K14 in both
LayerNorm flavours and K5', fp32 and bf16, at ragged row counts, depths over
32 that are no multiple of 32 (some deeper than the ring of three chunks),
an odd C and an odd C_out, each way to the rows' statistics, and the weight
in both
layouts the kernel reads without a copy (dcpt_tpu's contiguous (c, c_out),
and the transposed view of PyTorch's (c_out, c) that ``_ln_conv1x1``
passes), which give equal bits; every case run twice for equal bits, and at
each of the kernel's three block tiles forced (the same bits).  The
calls at the nets' B = 8 shapes run on the card
(``tests/test_torch_cuda_tc_fwd.py``).

Limits, relative to max(1, max|ref|), as ``chip_smoke.py`` holds the kernels
(``STANDALONE_TOL``): fp32 1e-5 (3xTF32 keeps about 2^-21 of each product and
the emulation sums exactly); bf16 2e-2, the kernel's bf16 output against the
plain version in fp32 on the same rounded inputs."""

import ctypes
import shutil

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401
from dcpt_tpu_torch.ops import ln_proj as lp
from dcpt_tpu_torch.ops import naf_ffn as nf
from dcpt_tpu_torch.tools.cuda_emu import build as emu

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="the CUDA emulation compiles with g++")

LIMIT = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return lp._bind(ctypes.CDLL(str(emu.build("ln_proj.cu", tmp_path_factory.mktemp("cuda_emu_ln_proj_tc")))))


def _inputs(rows, c, c_out, dtype):
    """x (rows, c) and ln_w, ln_b, the weight as PyTorch's (c_out, c), the output bias."""
    rng = np.random.default_rng(rows + c + c_out)

    def r(*shape, scale=0.5, shift=0.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale + shift).astype(np.float32)).to(dtype)

    return r(rows, c, scale=2.0, shift=0.5), r(c, shift=1.0), r(c), r(c_out, c, scale=c ** -0.5), r(c_out)


def _rel(got, want) -> float:
    assert got.shape == want.shape
    return ((got.float() - want.float()).abs().max() / max(1.0, want.float().abs().max().item())).item()


# (kernel, rows, C, C_out, dtype): 131 rows (a ragged row tile), C 48 (Restormer's first level:
# a full chunk and a half), the odd C 37, C 133 (five chunks through a ring of three, the last
# five deep), the odd C_out 101 (a ragged column tile).  fp32 and K5' defer the statistics to
# the streamed chunks; bf16 K14 takes them first: from the ring (C <= 64), from rows held in
# registers (C 136) or element by element (C 516, wider than the registers hold)
CASES = [("biasfree", 131, 48, 101, torch.float32), ("withbias", 131, 37, 70, torch.float32),
         ("biasfree", 100, 37, 101, torch.bfloat16), ("withbias", 131, 48, 70, torch.bfloat16),
         ("expand", 100, 133, 74, torch.float32), ("expand", 131, 37, 101, torch.bfloat16),
         ("withbias", 100, 136, 101, torch.bfloat16), ("biasfree", 70, 516, 70, torch.bfloat16)]
IDS = ["k14-biasfree-c48-f32", "k14-withbias-c37-f32", "k14-biasfree-c37-bf16", "k14-withbias-c48-bf16",
       "k5p-c133-f32", "k5p-c37-bf16", "k14-withbias-c136-bf16", "k14-biasfree-c516-bf16"]


@pytest.mark.parametrize("kernel,rows,c,c_out,dtype", CASES, ids=IDS)
def test_ln_proj_tensor_cores_emulated_vs_plain(lib, kernel, rows, c, c_out, dtype):
    x, ln_w, ln_b, w_pt, bias = _inputs(rows, c, c_out, dtype)
    biasfree = kernel == "biasfree"
    if biasfree:
        ln_b = torch.zeros_like(ln_b)
    view, dense = w_pt.t(), w_pt.t().contiguous()  # the module's view (strides (1, c)) and dcpt_tpu's (c, c_out)
    assert lp.weight_layout(view)[1:] == (c, 1) and lp.weight_layout(dense)[1:] == (c_out, 0)
    f32 = [t.float() for t in (x, ln_w, ln_b, dense, bias)]
    if kernel == "expand":
        ref = nf.naf_expand_ref(*f32)
        run = lambda w, tile=-1: lp.launch(lib, x, ln_w, ln_b, w, 1e-6, 0, bias=bias, tile=tile)  # noqa: E731
    else:
        ref = lp.ln_proj_ref(*f32[:4], 1e-5, biasfree)
        run = lambda w, tile=-1: lp.launch(lib, x, ln_w, ln_b, w, 1e-5, 0, biasfree=biasfree, tile=tile)  # noqa: E731
    got, again, other = run(view), run(view), run(dense)
    assert got.dtype == dtype and got.shape == (rows, c_out)
    assert torch.equal(got, again), "two runs on the same inputs differ"
    assert torch.equal(got, other), "the transposed view and the contiguous weight differ"
    assert _rel(got, ref) <= LIMIT[dtype]
    for tile in range(4):  # each block tile the kernel may pick, forced: the same bits
        assert torch.equal(run(view, tile), got), f"tile {tile} differs"


def test_weight_layout_copies_only_other_strides():
    """A contiguous weight and a transposed view of one reach the kernel as they are;
    a weight with other strides (a column slice) is copied, contiguous."""
    w = torch.randn(10, 24)
    assert lp.weight_layout(w)[0] is w
    view = torch.randn(24, 10).t()
    assert lp.weight_layout(view)[0] is view and lp.weight_layout(view)[1:] == (10, 1)
    sliced = w[:, ::2]
    got, ld, k_major = lp.weight_layout(sliced)
    assert got.is_contiguous() and torch.equal(got, sliced) and (ld, k_major) == (12, 0)


def test_wrappers_take_the_plain_version_on_the_cpu():
    """On CPU tensors both public functions return their plain versions and launch nothing."""
    x, ln_w, ln_b, w_pt, bias = _inputs(9, 37, 11, torch.float32)
    before = lp.fused_ln_proj.launches, nf.naf_expand.launches
    assert torch.equal(lp.fused_ln_proj(x, ln_w, ln_b, w_pt.t(), 1e-5), lp.ln_proj_ref(x, ln_w, ln_b, w_pt.t(), 1e-5))
    assert torch.equal(nf.naf_expand(x, ln_w, ln_b, w_pt.t(), bias), nf.naf_expand_ref(x, ln_w, ln_b, w_pt.t(), bias))
    assert (lp.fused_ln_proj.launches, nf.naf_expand.launches) == before
