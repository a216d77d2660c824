"""K7 (``csrc/mdta_block_bwd.cu``) and K2 (``csrc/naf_block_bwd.cu``), whose
products and weight gradients run on ``csrc/tc_gemm.cuh``'s tensor-core
product, built for the CPU by the port's CUDA emulation
(``dcpt_tpu_torch.tools.cuda_emu``, whose ``mma.sync`` takes TF32 operands and
sums exactly), against their plain versions: the tiles' ragged rows, columns
and depths (C 48 with F 127, C 40 with two heads, 3 x 2 maps), the epilogues
that write the gate backward, the scaled and gated operands and the per-image
sums, both flavours of K7, fp32 and bf16; every case run twice for equal bits.

Limits, relative to max(1, max|ref|): fp32 1e-5 (3xTF32 keeps about 2^-21 of
each product and the emulation sums exactly; one TF32 product a step would
read about 1e-3, the card's limit for these kernels in ``chip_smoke.py``);
bf16 2e-2, the kernel's bf16 output against the plain version in fp32 on the
same rounded inputs."""

import ctypes
import shutil
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401
from dcpt_tpu_torch.ops import mdta_block as mb
from dcpt_tpu_torch.ops import mdta_block_bwd as mbb
from dcpt_tpu_torch.ops import naf_block as nb
from dcpt_tpu_torch.ops import naf_block_bwd as nbb
from dcpt_tpu_torch.tools.cuda_emu import build as emu

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="the CUDA emulation compiles with g++")

LIMIT = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
RELU, SOFTMAX = (False, False, 1e-6), (True, True, 1e-5)  # K7's flavours: (use_softmax, ln_bias, eps)


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    out = tmp_path_factory.mktemp("cuda_emu_bwd_tc")
    binds = {"mdta_block": mb._bind, "mdta_block_bwd": mbb._bind, "naf_block": nb._bind, "naf_block_bwd": nbb._bind}
    with ThreadPoolExecutor(len(binds)) as pool:  # one g++ a source
        built = dict(zip(binds, pool.map(lambda name: emu.build(name + ".cu", out / name), binds)))
    return {name: bind(ctypes.CDLL(str(built[name]))) for name, bind in binds.items()}


def _worst(got, want) -> float:
    """The largest error of the cotangents relative to max(1, max|want|), after
    checking each one's shape against the plain version's."""
    worst = 0.0
    for g, w in zip(got, want, strict=True):
        assert g.shape == w.shape
        worst = max(worst, ((g.float() - w.float()).abs().max() / max(1.0, w.float().abs().max().item())).item())
    return worst


def _twice(launch):
    got, again = launch(), launch()
    assert all(torch.equal(a, b) for a, b in zip(got, again)), "two runs on the same inputs differ"
    return got


def _rand(rng, dtype, *shape, scale=0.3, shift=0.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale + shift).astype(np.float32)).to(dtype)


# (B, H, W, C, heads, flavour, dtype): Restormer's first stage width (C 48, F 127: no
# operand row a multiple of 4 elements), a ragged C 40 with two heads (F 106) on a
# 3 x 2 map, two images of 3 x 5 (the gate epilogue's image index)
@pytest.mark.parametrize("b,h,w,c,heads,flavour,dtype", [
    (1, 4, 4, 48, 1, RELU, torch.float32),
    (1, 4, 4, 48, 1, SOFTMAX, torch.bfloat16),
    (1, 3, 2, 40, 2, SOFTMAX, torch.float32),
    (1, 3, 2, 40, 2, RELU, torch.bfloat16),
    (2, 3, 5, 40, 2, SOFTMAX, torch.float32),
], ids=["c48-relu-f32", "c48-softmax-bf16", "c40-3x2-softmax-f32", "c40-3x2-relu-bf16", "b2-c40-softmax-f32"])
def test_k7_tensor_cores_emulated_vs_plain(libs, b, h, w, c, heads, flavour, dtype):
    """All 12 cotangents of K7 from K6's residuals against mdta_block_bwd_ref."""
    rng = np.random.default_rng(b + h + w + c)
    f = int(c * 2.66)
    x = _rand(rng, dtype, b, h, w, c, scale=1.0)
    params = [_rand(rng, dtype, c, shift=1.0), _rand(rng, dtype, c), _rand(rng, dtype, c, 3 * c, scale=c ** -0.5),
              _rand(rng, dtype, 3, 3, 3 * c, scale=1 / 3), _rand(rng, dtype, heads, 1, 1, shift=1.0),
              _rand(rng, dtype, c, c, scale=c ** -0.5), _rand(rng, dtype, c, shift=1.0), _rand(rng, dtype, c),
              _rand(rng, dtype, c, 2 * f, scale=c ** -0.5), _rand(rng, dtype, 3, 3, 2 * f, scale=1 / 3),
              _rand(rng, dtype, f, c, scale=f ** -0.5)]
    dz = _rand(rng, dtype, b, h, w, c, scale=1.0)
    _, res = mb._launch(libs["mdta_block"], x, params, heads, *flavour, 0, residuals=True)
    got = _twice(lambda: mbb._launch(libs["mdta_block_bwd"], x, params, dz, res, heads, *flavour, 0))
    assert all(g.dtype == dtype for g in got)
    want = mbb.mdta_block_bwd_ref(x.float(), *[p.float() for p in params], *res[:4], dz.float(), heads, *flavour)
    assert _worst(got, want) <= LIMIT[dtype]


# (B, H, W, C, dtype): NAFNet-w64's first width and twice it (two 96-wide column tiles
# of a 128-wide product), ragged maps of one D tile; two images (per-image att and datt)
@pytest.mark.parametrize("b,h,w,c,dtype", [
    (1, 5, 3, 64, torch.float32),
    (2, 3, 5, 64, torch.bfloat16),
    (1, 7, 3, 128, torch.float32),
    (1, 4, 5, 128, torch.bfloat16),
], ids=["c64-f32", "b2-c64-bf16", "c128-f32", "c128-bf16"])
def test_k2_tensor_cores_emulated_vs_plain(libs, b, h, w, c, dtype):
    """All 19 cotangents of K2 from K1's residuals against naf_block_bwd_ref."""
    rng = np.random.default_rng(b + h + w + c)
    s = c ** -0.5
    x = _rand(rng, dtype, b, h, w, c, scale=1.0)
    params = [_rand(rng, dtype, c, shift=1.0), _rand(rng, dtype, c), _rand(rng, dtype, c, 2 * c, scale=s),
              _rand(rng, dtype, 2 * c), _rand(rng, dtype, 3, 3, 2 * c, scale=1 / 3), _rand(rng, dtype, 2 * c),
              _rand(rng, dtype, c, c, scale=s), _rand(rng, dtype, c), _rand(rng, dtype, c, c, scale=s),
              _rand(rng, dtype, c), _rand(rng, dtype, c), _rand(rng, dtype, c, shift=1.0), _rand(rng, dtype, c),
              _rand(rng, dtype, c, 2 * c, scale=s), _rand(rng, dtype, 2 * c), _rand(rng, dtype, c, c, scale=s),
              _rand(rng, dtype, c), _rand(rng, dtype, c, shift=0.5)]
    dz = _rand(rng, dtype, b, h, w, c, scale=1.0)
    _, (*maps, pooled, att) = nb._launch(libs["naf_block"], x, params, 1e-6, 0, residuals=True)
    got = _twice(lambda: nbb._launch(libs["naf_block_bwd"], x, params, pooled, att, dz, maps, 1e-6, 0))
    assert all(g.dtype == dtype for g in got)
    want = nbb.naf_block_bwd_ref(x.float(), *[p.float() for p in params], pooled, att, dz.float())
    assert _worst(got, want) <= LIMIT[dtype]
