"""K13 (``mdta_attention``, ``csrc/mdta.cu``), whose Gram and attn . v run on
the tensor cores through ``csrc/tc_gemm.cuh``'s pieces, built for the CPU by
the port's CUDA emulation (``dcpt_tpu_torch.tools.cuda_emu``, whose
``mma.sync`` takes TF32 operands and sums exactly), against its plain
version: head widths 37 (ragged tiles), 40, 48, 96 and 176 (2 x 2 Gram
tiles of 96) at L of 37 or 300, and L 4100 at narrow widths (33 chunks: the
reduce pass sums them in slices); ReLU and softmax, fp32 and bf16; one chunk
and one tile per head (the Gram's block takes attn itself: two launches) and
the reduce pass (three).  Every case runs twice at the kernel's own tile
(equal bits) and at each tile family forced (the same bits).  One case at
(2, 48, 256) is held against dcpt_tpu's own ``mdta_attention`` in interpret
mode, the workspace size reckoned in Python against the C entry's, and the
launches a call against those the emulated kernel makes.  The
calls at the nets' shapes run on the card (``tests/test_torch_cuda_k13.py``).

Limits, relative to max(1, max|ref|), as ``chip_smoke.py`` holds K13
(``K13_TOL``): fp32 1e-4, bf16 2e-2 (the kernel's bf16 output against the
plain version in fp32 on the same rounded inputs)."""

import ctypes
import shutil

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401
from dcpt_tpu_torch.ops import mdta as md
from dcpt_tpu_torch.tools.cuda_emu import build as emu

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="the CUDA emulation compiles with g++")

LIMIT = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return md._bind(ctypes.CDLL(str(emu.build("mdta.cu", tmp_path_factory.mktemp("cuda_emu_mdta_tc")))))


def _inputs(bh, c, length, dtype, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((bh, c, length)).astype(np.float32)).to(dtype) for _ in range(3))
    t = torch.from_numpy((rng.random((bh, 1, 1)) + 0.5).astype(np.float32)).to(dtype)
    return q, k, v, t


def _rel(got, want) -> float:
    assert got.shape == want.shape
    return ((got.float() - want.float()).abs().max() / max(1.0, want.float().abs().max().item())).item()


# (BH, c, L, softmax, dtype): one chunk a head under 257 pixels; c <= 48 takes the 48 tiles, c > 48
# the 96 ones (176: 2 x 2 Gram tiles, two row tiles of attn . v)
CASES = [(2, 37, 300, False, torch.float32), (3, 48, 37, True, torch.float32), (1, 40, 300, True, torch.bfloat16),
         (2, 48, 256, False, torch.bfloat16), (2, 96, 300, True, torch.float32), (1, 96, 37, False, torch.bfloat16),
         (1, 176, 37, False, torch.float32), (1, 176, 300, True, torch.bfloat16), (1, 5, 4100, True, torch.float32),
         (1, 40, 4100, False, torch.bfloat16)]
IDS = ["c37-L300-relu-f32", "c48-L37-softmax-f32", "c40-L300-softmax-bf16", "c48-L256-relu-bf16",
       "c96-L300-softmax-f32", "c96-L37-relu-bf16", "c176-L37-relu-f32", "c176-L300-softmax-bf16",
       "c5-L4100-softmax-f32", "c40-L4100-relu-bf16"]


@pytest.mark.parametrize("bh,c,length,use_softmax,dtype", CASES, ids=IDS)
def test_mdta_tensor_cores_emulated_vs_plain(lib, bh, c, length, use_softmax, dtype):
    q, k, v, t = _inputs(bh, c, length, dtype, bh + c + length)
    got = md._launch(lib, q, k, v, t, use_softmax, 0)
    assert got.dtype == dtype and got.shape == q.shape
    ref = md.mdta_ref(q.float(), k.float(), v.float(), t.float(), use_softmax)
    assert _rel(got, ref) <= LIMIT[dtype]
    assert torch.equal(md._launch(lib, q, k, v, t, use_softmax, 0), got)  # twice: the same bits
    for tile in (0, 1):  # each tile family forced (48, 96): the same bits
        assert torch.equal(md._launch(lib, q, k, v, t, use_softmax, 0, tile=tile), got), tile


def test_mdta_workspace_and_launches_reckoned_as_the_kernel(lib):
    """The wrapper's workspace size, reckoned in Python, equals the C entry's; its launch count
    a call equals the launches the emulated kernel makes (two where one chunk and one tile
    cover a head, else three)."""
    for bh, c, length in [(1, 48, 16384), (8, 48, 16384), (2, 48, 4096), (4, 48, 1024), (8, 48, 256),
                          (1, 96, 16384), (4, 176, 256), (4, 80, 1024), (4, 40, 4096), (3, 37, 1000), (1, 5, 4100),
                          (1, 1, 1), (7, 300, 257), (0, 48, 256), (2, 48, 0)]:
        assert md.workspace_floats(bh, c, length) == lib.mdta_workspace_floats(bh, c, length), (bh, c, length)
    lib.cuda_emu_launches.restype = ctypes.c_longlong
    for bh, c, length in [(2, 48, 256), (1, 96, 37), (1, 60, 200), (1, 176, 37), (3, 37, 300), (1, 5, 4100)]:
        q, k, v, t = _inputs(bh, c, length, torch.float32, c)
        before = lib.cuda_emu_launches()
        md._launch(lib, q, k, v, t, False, 0)
        assert lib.cuda_emu_launches() - before == md.launches_per_call(bh, c, length), (bh, c, length)
    assert md.num_chunks(1, 48, 16384) == 128 and md.num_chunks(8, 48, 16384) == 32 and md.num_chunks(8, 48, 256) == 1


@pytest.mark.parametrize("dtype", [torch.float32])
def test_mdta_emulated_vs_dcpt_tpu_interpret(lib, dtype):
    """(2, 48, 256), ReLU and softmax: the kernel under the emulation against dcpt_tpu's
    Pallas ``mdta_attention`` in interpret mode on the same inputs."""
    jnp = pytest.importorskip("jax.numpy")
    from dcpt_tpu.ops import mdta as jmd

    q, k, v, t = _inputs(2, 48, 256, dtype, 16)
    for use_softmax in (False, True):
        got = md._launch(lib, q, k, v, t, use_softmax, 0)
        want = jmd.mdta_attention(*(jnp.asarray(x.numpy()) for x in (q, k, v, t)), use_softmax, True)
        assert _rel(got, torch.from_numpy(np.asarray(want))) <= LIMIT[dtype], use_softmax
