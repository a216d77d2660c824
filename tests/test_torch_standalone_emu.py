"""The CUDA sources of the standalone ops (``csrc/window_process.cu`` K11,
``csrc/fused_act.cu`` K12, ``csrc/ln_proj.cu`` K14 and K5', ``csrc/mdta.cu``
K13) built for the CPU by the port's CUDA emulation
(``dcpt_tpu_torch.tools.cuda_emu``) and run through each wrapper's launch
function on CPU tensors, against the plain versions at small ragged shapes:
K11 and K12 bit for bit, K13 and K14 within 1e-5 (fp32) and 2e-2 (bf16)
relative to max(1, max|ref|), the bf16 kernels against the plain versions in
fp32 on the same rounded inputs (K14 against its bf16 plain version too,
whose roundings it follows)."""

import ctypes
import shutil

import pytest
import torch

from dcpt_tpu_torch.ops import fused_act as fa
from dcpt_tpu_torch.ops import ln_proj as lp
from dcpt_tpu_torch.ops import mdta as md
from dcpt_tpu_torch.ops import naf_ffn as nf
from dcpt_tpu_torch.ops import window_process as wp
from dcpt_tpu_torch.tools.cuda_emu import build as emu

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="the CUDA emulation compiles with g++")

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """Each source built once for the module, bound as its ops module binds nvcc's build."""
    out = tmp_path_factory.mktemp("cuda_emu_standalone")
    return {name: bind(ctypes.CDLL(str(emu.build(name + ".cu", out))))
            for name, bind in (("window_process", wp._bind), ("fused_act", fa._bind), ("ln_proj", lp._bind),
                               ("mdta", md._bind))}


def _rel(got: torch.Tensor, ref: torch.Tensor) -> float:
    return (got.float() - ref.float()).abs().max().item() / max(1.0, ref.float().abs().max().item())


def _rand(gen, *shape, dtype=torch.float32, scale=1.0, shift=0.0):
    return (torch.randn(*shape, generator=gen) * scale + shift).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8, torch.complex128])
def test_window_process_emulated_is_exact(libs, dtype):
    """Partition and reverse of a 12 x 8 map (ws 4, C = 5: rows wrap mid-window at
    shift 3) at shifts 0, 3, 6 and -3, every element width the kernel takes (1, 2,
    4, 16 bytes), equal to torch.roll + view and back to the map."""
    lib = libs["window_process"]
    gen = torch.Generator().manual_seed(1)
    x = (torch.randn(2, 12, 8, 5, generator=gen) * 50).to(dtype) if dtype != torch.complex128 else \
        torch.randn(2, 12, 8, 5, dtype=dtype, generator=gen)
    for shift in (0, 3, 6, -3):
        win = torch.empty(2 * 3 * 2, 16, 5, dtype=dtype)
        wp._launch(lib, x, win, 2, 12, 8, 5, 4, shift, False, 0)
        assert torch.equal(win, wp.window_partition_ref(x, 4, shift)), shift
        back = torch.empty_like(x)
        wp._launch(lib, win, back, 2, 12, 8, 5, 4, shift, True, 0)
        assert torch.equal(back, x), shift


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_act_emulated_is_exact(libs, dtype):
    """Forward (out and mask) and backward (gx) on (3, 5, 37) rows, one row at
    x + b == 0, bit for bit against the plain versions."""
    lib = libs["fused_act"]
    gen = torch.Generator().manual_seed(2)
    x, b, g = _rand(gen, 3, 5, 37, dtype=dtype), _rand(gen, 37, dtype=dtype), _rand(gen, 3, 5, 37, dtype=dtype)
    x[1, 2] = -b
    out, mask = fa._launch_fwd(lib, x, b, 0.2, 2 ** 0.5, 0)
    ref, ref_mask = fa.fused_bias_leaky_relu_ref(x, b)
    assert torch.equal(out, ref) and torch.equal(mask, ref_mask) and mask.dtype == torch.int8
    assert not mask[1, 2].any()
    assert torch.equal(fa._launch_bwd(lib, g, mask, 0.2, 2 ** 0.5, 0), fa.fused_bias_leaky_relu_bwd_ref(g, ref_mask))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ln_proj_emulated(libs, dtype):
    """K14 in both flavours and naf_expand's entry at ragged widths (70 rows: two
    row tiles; C = 37: a ragged 32-deep chunk; N = 70: two column blocks)."""
    lib = libs["ln_proj"]
    gen = torch.Generator().manual_seed(3)
    rows, c, n = 70, 37, 70
    x = _rand(gen, rows, c, dtype=dtype, scale=2.0, shift=0.5)
    ln_w, ln_b = _rand(gen, c, dtype=dtype, scale=0.5, shift=1.0), _rand(gen, c, dtype=dtype)
    w, bias = _rand(gen, c, n, dtype=dtype, scale=c ** -0.5), _rand(gen, n, dtype=dtype)
    f32 = [t.float() for t in (x, ln_w, ln_b, w, bias)]
    for biasfree in (True, False):
        lb = torch.zeros_like(ln_b) if biasfree else ln_b
        got = lp.launch(lib, x, ln_w, lb, w, 1e-5, 0, biasfree=biasfree)
        assert got.dtype == dtype and got.shape == (rows, n)
        assert _rel(got, lp.ln_proj_ref(f32[0], f32[1], lb.float(), f32[3], 1e-5, biasfree)) <= TOL[dtype], biasfree
        assert _rel(got, lp.ln_proj_ref(x, ln_w, lb, w, 1e-5, biasfree)) <= TOL[dtype], biasfree
    got = lp.launch(lib, x, ln_w, ln_b, w, 1e-6, 0, bias=bias)
    assert _rel(got, nf.naf_expand_ref(*f32)) <= TOL[dtype]


@pytest.mark.parametrize("use_softmax", [False, True])
def test_mdta_emulated(libs, use_softmax):
    """K13 at head widths 5 and 70 (two Gram tiles and two attn . v row tiles), L
    of 37, 300 (ten 32-pixel chunks) and 4100 (65 chunks: colsum in two passes),
    fp32; and bf16 at the first two."""
    lib = libs["mdta"]
    gen = torch.Generator().manual_seed(4 + use_softmax)
    for dtype, shapes in ((torch.float32, [(3, 5, 37), (1, 70, 300), (1, 5, 4100)]),
                          (torch.bfloat16, [(3, 5, 37), (1, 70, 300)])):
        for bh, c, length in shapes:
            q, k, v = (_rand(gen, bh, c, length, dtype=dtype) for _ in range(3))
            t = (torch.rand(bh, generator=gen) + 0.5).to(dtype)
            got = md._launch(lib, q, k, v, t, use_softmax, 0)
            assert got.dtype == dtype and got.shape == q.shape
            ref = md.mdta_ref(q.float(), k.float(), v.float(), t.float(), use_softmax)
            assert _rel(got, ref) <= TOL[dtype], (dtype, bh, c, length)
