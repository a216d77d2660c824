"""K6 (``csrc/mdta_block.cu``) and K1 (``csrc/naf_block.cu``), whose 1x1 products
run on ``csrc/tc_gemm.cuh``'s tensor-core product, built for the CPU by the
port's CUDA emulation (``dcpt_tpu_torch.tools.cuda_emu``, whose ``mma.sync``
takes TF32 operands and sums exactly), against their plain versions: rows of
F = 127 floats (no multiple of 4: staged by 4-byte copies), products cut
along their depth where their tiles would leave the card idle (a 32 x 32 map,
their chunks added before the epilogue), both LayerNorm flavours of K6, the gate pass's image-row segments
and the residuals that the backward kernels read, fp32 and bf16; every case
run twice for equal bits.

Limits, relative to max(1, max|ref|): fp32 1e-5 (3xTF32 keeps about 2^-21 of
each product and the emulation sums exactly); bf16 2e-2, the kernel's bf16
output against the plain version in fp32 on the same rounded inputs."""

import ctypes
import shutil
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import _torch_threads  # noqa: F401
from dcpt_tpu_torch.ops import mdta_block as mb
from dcpt_tpu_torch.ops import naf_block as nb
from dcpt_tpu_torch.tools.cuda_emu import build as emu

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="the CUDA emulation compiles with g++")

LIMIT = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
RELU, SOFTMAX = (False, False, 1e-6), (True, True, 1e-5)  # K6's flavours: (use_softmax, ln_bias, eps)


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    out = tmp_path_factory.mktemp("cuda_emu_fwd_tc")
    binds = {"mdta_block": mb._bind, "naf_block": nb._bind}
    with ThreadPoolExecutor(len(binds)) as pool:  # one g++ a source
        built = dict(zip(binds, pool.map(lambda name: emu.build(name + ".cu", out / name), binds)))
    return {name: bind(ctypes.CDLL(str(built[name]))) for name, bind in binds.items()}


def _rel(got, want) -> float:
    assert got.shape == want.shape
    return ((got.float() - want.float()).abs().max() / max(1.0, want.float().abs().max().item())).item()


def _flat(out) -> list:
    """A launch's tensors: z, or z and its residuals."""
    return [t for item in out for t in _flat(item)] if isinstance(out, tuple) else [out]


def _twice(launch):
    got, again = launch(), launch()
    assert all(torch.equal(a, b) for a, b in zip(_flat(got), _flat(again), strict=True)), \
        "two runs on the same inputs differ"
    return got


def _rand(rng, dtype, *shape, scale=0.3, shift=0.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale + shift).astype(np.float32)).to(dtype)


def _k6_inputs(b, h, w, c, heads, dtype):
    rng = np.random.default_rng(b + h + w + c)
    f = int(c * 2.66)
    r = lambda *shape, **kw: _rand(rng, dtype, *shape, **kw)  # noqa: E731
    return r(b, h, w, c, scale=1.0), [r(c, shift=1.0), r(c), r(c, 3 * c, scale=c ** -0.5), r(3, 3, 3 * c, scale=1 / 3),
                                      r(heads, 1, 1, shift=1.0), r(c, c, scale=c ** -0.5), r(c, shift=1.0), r(c),
                                      r(c, 2 * f, scale=c ** -0.5), r(3, 3, 2 * f, scale=1 / 3),
                                      r(f, c, scale=f ** -0.5)]


def _k1_inputs(b, h, w, c, dtype):
    rng = np.random.default_rng(b + h + w + c)
    s = c ** -0.5
    r = lambda *shape, scale=0.5, shift=0.0: _rand(rng, dtype, *shape, scale=scale, shift=shift)  # noqa: E731
    return r(b, h, w, c, scale=1.0), [r(c, shift=1.0), r(c), r(c, 2 * c, scale=s), r(2 * c), r(3, 3, 2 * c, scale=1 / 3),
                                      r(2 * c), r(c, c, scale=s), r(c), r(c, c, scale=s), r(c), r(c), r(c, shift=1.0),
                                      r(c), r(c, 2 * c, scale=s), r(2 * c), r(c, c, scale=s), r(c), r(c, shift=0.5)]


# (B, H, W, C, heads, flavour, dtype): Restormer's first width (C 48, F 127) on one 96-row
# tile; a 32 x 32 map (1024 rows, the fewest a forward cuts), where every product's tiles
# leave the card idle and it is cut along its depth; C 80 on 1 x 2 (too few rows to cut);
# C 96 on 3 x 2; two images of 3 x 5 with two heads
@pytest.mark.parametrize("b,h,w,c,heads,flavour,dtype", [
    (1, 4, 4, 48, 1, RELU, torch.float32),
    (1, 32, 32, 40, 2, SOFTMAX, torch.float32),
    (1, 1, 2, 80, 2, RELU, torch.float32),
    (1, 3, 2, 96, 2, RELU, torch.bfloat16),
    (2, 3, 5, 40, 2, SOFTMAX, torch.bfloat16),
], ids=["c48-f127-relu-f32", "c40-cut-softmax-f32", "c80-1x2-relu-f32", "c96-relu-bf16", "b2-c40-softmax-bf16"])
def test_k6_tensor_cores_emulated_vs_plain(libs, b, h, w, c, heads, flavour, dtype):
    x, params = _k6_inputs(b, h, w, c, heads, dtype)
    z = _twice(lambda: mb._launch(libs["mdta_block"], x, params, heads, *flavour, 0))
    assert z.dtype == dtype
    ref = mb.mdta_block_ref(x.float(), *[p.float() for p in params], heads, *flavour)
    assert _rel(z, ref) <= LIMIT[dtype]


def test_k6_residual_maps_emulated_vs_plain(libs):
    """The maps K7 reads (t, qkv, o, y, u, g; fp32, their layouts) against the plain
    computation, C 48 and F 127, WithBias LayerNorms."""
    c, heads, flavour = 48, 2, SOFTMAX
    x, p = _k6_inputs(1, 3, 4, c, heads, torch.float32)
    z, (gram, qn2, kn2, attn, t, qkv, o, y, u, g) = _twice(
        lambda: mb._launch(libs["mdta_block"], x, p, heads, *flavour, 0, residuals=True))
    b, h, w, _ = x.shape
    ln1 = mb.ln_channel(x.reshape(-1, c), p[0], p[1], flavour[2], True).reshape(x.shape)
    t_ref = ln1 @ p[2]
    qkv_ref = mb._dwconv(t_ref, p[3])
    o_ref = torch.einsum("bpd,bcd->bpc", qkv_ref.reshape(b, h * w, 3 * c)[..., 2 * c:], attn).reshape(x.shape)
    y_ref = x + o_ref @ p[5]
    u_ref = mb.ln_channel(y_ref.reshape(-1, c), p[6], p[7], flavour[2], True).reshape(x.shape) @ p[8]
    d = mb._dwconv(u_ref, p[9])
    f = p[10].shape[0]
    g_ref = F.gelu(d[..., :f]) * d[..., f:]
    for got, want in ((t, t_ref), (qkv, qkv_ref), (o, o_ref), (y, y_ref), (u, u_ref), (g, g_ref)):
        assert got.dtype == torch.float32 and got.is_contiguous()
        assert _rel(got, want) <= LIMIT[torch.float32]
    assert _rel(z, y_ref + g_ref @ p[10]) <= LIMIT[torch.float32]


# (B, H, W, C, dtype): one pixel; 32 x 32 (every product cut along its depth); two images
# of 3 x 37 (two gate segments a row, per-image att); C 128 on 1 x 2
@pytest.mark.parametrize("b,h,w,c,dtype", [
    (1, 1, 1, 64, torch.float32),
    (1, 32, 32, 64, torch.float32),
    (2, 3, 37, 64, torch.bfloat16),
    (1, 1, 2, 128, torch.bfloat16),
], ids=["c64-1x1-f32", "c64-cut-f32", "b2-c64-segments-bf16", "c128-bf16"])
def test_k1_tensor_cores_emulated_vs_plain(libs, b, h, w, c, dtype):
    x, params = _k1_inputs(b, h, w, c, dtype)
    z = _twice(lambda: nb._launch(libs["naf_block"], x, params, 1e-6, 0))
    assert z.dtype == dtype
    ref = nb.naf_block_ref(x.float(), *[p.float() for p in params])
    assert _rel(z, ref) <= LIMIT[dtype]


def test_k1_residual_maps_emulated_vs_plain(libs):
    """The maps K2 reads (t, u, y, h, o fp32; g in the I/O type; pooled, att) against
    the plain computation, on two images with two gate segments a row."""
    x, p = _k1_inputs(2, 2, 35, 64, torch.float32)
    (n1w, n1b, w1, b1, wdw, bdw, wsca, bsca, w3, b3, beta, n2w, n2b, w4, b4, w5, b5, gamma) = p
    z, (g, t, u, y, h, o, pooled, att) = _twice(lambda: nb._launch(libs["naf_block"], x, p, 1e-6, 0, residuals=True))
    c = x.shape[-1]
    t_ref = nb.layer_norm_last(x, n1w, n1b, 1e-6) @ w1 + b1
    d = F.conv2d(t_ref.permute(0, 3, 1, 2), wdw.permute(2, 0, 1).unsqueeze(1), bdw, padding=1, groups=2 * c)
    d = d.permute(0, 2, 3, 1)
    g_ref = d[..., :c] * d[..., c:]
    pooled_ref = g_ref.mean(dim=(1, 2))
    att_ref = pooled_ref @ wsca + bsca
    u_ref = (g_ref * att_ref[:, None, None, :]) @ w3 + b3
    y_ref = x + u_ref * beta
    h_ref = nb.layer_norm_last(y_ref, n2w, n2b, 1e-6) @ w4 + b4
    o_ref = (h_ref[..., :c] * h_ref[..., c:]) @ w5 + b5
    for got, want in ((g, g_ref), (t, t_ref), (u, u_ref), (y, y_ref), (h, h_ref), (o, o_ref), (pooled, pooled_ref),
                      (att, att_ref), (z, y_ref + o_ref * gamma)):
        assert got.is_contiguous()
        assert _rel(got, want) <= LIMIT[torch.float32]
