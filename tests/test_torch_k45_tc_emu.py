"""K4 (``csrc/naf_prefix.cu``) and K5 (``csrc/naf_ffn.cu``), whose 1x1 products
run on ``csrc/tc_gemm.cuh``'s tensor-core product through the passes they
share with K1 (``csrc/naf_common.cuh``), built for the CPU by the port's CUDA
emulation (``dcpt_tpu_torch.tools.cuda_emu``, whose ``mma.sync`` takes TF32
operands and sums exactly), against their plain versions: a ragged 15 x 9
map, a 32 x 32 map (1024 rows, the fewest that K1 cuts; K4 and K5 cut every
product whose tiles leave the card idle, as at all these sizes, along its
depth into two or more chunks), a wider C in bf16 with two gate segments a
row, and an odd C (rows staged by 4-byte copies or plain loads, W5's last
column pair masked), fp32 and bf16; every case run twice for equal bits.
The uncut products (K4's W1 and K5's W4 at B = 8 on the c = 512 stage) run on
the card (``tests/test_torch_cuda_tc_fwd.py``).

Limits, relative to max(1, max|ref|), as ``test_torch_fwd_tc_emu.py``: fp32
1e-5 (3xTF32 keeps about 2^-21 of each product and the emulation sums
exactly); bf16 2e-2, the kernel's bf16 output against the plain version in
fp32 on the same rounded inputs."""

import ctypes
import shutil
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401
from dcpt_tpu_torch.ops import naf_ffn as nff
from dcpt_tpu_torch.ops import naf_prefix as npf
from dcpt_tpu_torch.tools.cuda_emu import build as emu

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="the CUDA emulation compiles with g++")

LIMIT = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
KERNELS = {"K4": (npf, "naf_prefix"), "K5": (nff, "naf_ffn")}


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    out = tmp_path_factory.mktemp("cuda_emu_k45_tc")
    with ThreadPoolExecutor(len(KERNELS)) as pool:  # one g++ a source
        built = dict(zip(KERNELS, pool.map(lambda k: emu.build(KERNELS[k][1] + ".cu", out / k), KERNELS)))
    return {k: mod._bind(ctypes.CDLL(str(built[k]))) for k, (mod, _) in KERNELS.items()}


def _inputs(b, h, w, c, dtype):
    """x and the parameters of K4 (LN1, W1 (C, 2C), b1, wdw (3, 3, 2C), bdw) and of
    K5 (LN2, W4 (C, 2C), b4, W5 (C, C), b5, gamma) in the op's layouts."""
    rng = np.random.default_rng(b + h + w + c)

    def r(*shape, scale=0.5, shift=0.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale + shift).astype(np.float32)).to(dtype)

    s = c ** -0.5
    prefix = [r(c, shift=1.0), r(c), r(c, 2 * c, scale=s), r(2 * c), r(3, 3, 2 * c, scale=1 / 3), r(2 * c)]
    ffn = [r(c, shift=1.0), r(c), r(c, 2 * c, scale=s), r(2 * c), r(c, c, scale=s), r(c), r(c, shift=0.5)]
    return r(b, h, w, c, scale=1.0), prefix, ffn


def _rel(got, want) -> float:
    assert got.shape == want.shape
    return ((got.float() - want.float()).abs().max() / max(1.0, want.float().abs().max().item())).item()


# (B, H, W, C, dtype): the ragged 15 x 9 of a 120 x 72 image; 32 x 32 (1024 rows,
# the products cut into two chunks of 32); two images of 3 x 37
# at C 128 (two gate segments a row); one pixel and a 5 x 3 map at an odd C
CASES = [(1, 15, 9, 64, torch.float32), (1, 32, 32, 64, torch.float32), (2, 3, 37, 128, torch.bfloat16),
         (1, 1, 1, 37, torch.float32), (2, 5, 3, 37, torch.bfloat16)]
IDS = ["ragged-15x9-f32", "cut-32x32-f32", "c128-segments-bf16", "c37-1x1-f32", "c37-bf16"]


@pytest.mark.parametrize("kernel", ["K4", "K5"])
@pytest.mark.parametrize("b,h,w,c,dtype", CASES, ids=IDS)
def test_k4_k5_tensor_cores_emulated_vs_plain(libs, kernel, b, h, w, c, dtype):
    x, prefix, ffn = _inputs(b, h, w, c, dtype)
    if kernel == "K4":
        launch = lambda: npf._launch(libs["K4"], x, prefix, 1e-6, 0)  # noqa: E731
        ref = npf.naf_prefix_ref(x.float(), *[p.float() for p in prefix])
    else:
        launch = lambda: nff._launch(libs["K5"], x, ffn, 1e-6, 0)  # noqa: E731
        ref = nff.naf_ffn_ref(x.float(), *[p.float() for p in ffn])
    got, again = launch(), launch()
    assert torch.equal(got, again), "two runs on the same inputs differ"
    assert got.dtype == dtype and got.shape == x.shape
    assert _rel(got, ref) <= LIMIT[dtype]


def test_k4_k5_checks_take_any_width():
    """The wrappers' input checks take every C from 1 to 8192 (the products mask
    ragged widths), and refuse a parameter whose shape does not follow C."""
    x, prefix, ffn = _inputs(1, 2, 3, 37, torch.float32)
    npf._check(x, prefix)
    nff._check(x, ffn)
    with pytest.raises(ValueError, match="C in 1..8192"):
        npf._check(torch.zeros(1, 1, 1, 8193), prefix)
    with pytest.raises(ValueError, match="parameter 3"):
        nff._check(x, [*ffn[:2], ffn[2][:, :10], *ffn[3:]])
