"""K6 (the TransformerBlock forward), K1 (the NAFBlock forward), K4 and K5
(the NAFBlock's prefix and FFN half), and K14 and K5' (``csrc/ln_proj.cu``:
the LayerNorm fused with a 1x1 projection) on the card, whose 1x1 products
run on the tensor cores (``csrc/tc_gemm.cuh`` and its pieces): each at the
train ymls' batch 8 against its plain version, twice for equal bits, and its
launches by pass.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU: a CUDA
kernel has no CPU mode.  The file imports neither JAX nor dcpt_tpu; from the
repo root:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda_tc_fwd.py

Limits, relative to max(1, max|ref|), as ``chip_smoke.py`` holds the kernels:
fp32 1e-4 (K14 and K5' 1e-5, ``STANDALONE_TOL``), bf16 2e-2 (the bf16 kernel
against the plain version in fp32 on the same rounded inputs).
"""

import numpy as np
import pytest
import torch

from dcpt_tpu_torch.ops import ln_proj as tlp
from dcpt_tpu_torch.ops import mdta_block as tmb
from dcpt_tpu_torch.ops import naf_block as tnb
from dcpt_tpu_torch.ops import naf_ffn as tnff
from dcpt_tpu_torch.ops import naf_prefix as tnpf
from dcpt_tpu_torch.tools.swin_ab import pass_split

pytestmark = pytest.mark.cuda

LIMIT = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
RELU, SOFTMAX = (False, False, 1e-6), (True, True, 1e-5)  # K6's flavours: (use_softmax, ln_bias, eps)
# the SIMT product kernels the tensor-core products replaced
RETIRED = ("mdta_qkv_kernel", "mdta_proj_kernel", "mdta_ffn_in_kernel", "mdta_ffn_out_kernel", "naf_p1_kernel",
           "naf_p2a_kernel", "naf_p2b_kernel", "naf_p2c_kernel")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rand(rng, device, dtype, *shape, scale=0.3, shift=0.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale + shift).astype(np.float32)).to(device, dtype)


def _k6_call(device, b, s, c, heads, flavour, dtype):
    """(launch, plain output) of K6 at (B, s, s, C)."""
    rng = np.random.default_rng(c + s)
    f = int(c * 2.66)
    r = lambda *shape, **kw: _rand(rng, device, dtype, *shape, **kw)  # noqa: E731
    params = [r(c, shift=1.0), r(c), r(c, 3 * c, scale=c ** -0.5), r(3, 3, 3 * c, scale=1 / 3),
              r(heads, 1, 1, shift=1.0), r(c, c, scale=c ** -0.5), r(c, shift=1.0), r(c),
              r(c, 2 * f, scale=c ** -0.5), r(3, 3, 2 * f, scale=1 / 3), r(f, c, scale=f ** -0.5)]
    x = r(b, s, s, c, scale=1.0)
    ref = tmb.mdta_block_ref(x.float(), *[p.float() for p in params], heads, *flavour)
    return (lambda: tmb._kernel_forward(x, params, heads, *flavour)), ref


def _k1_call(device, b, s, c, dtype):
    """(launch, plain output) of K1 at (B, s, s, C)."""
    rng = np.random.default_rng(c + s)
    sc = c ** -0.5
    r = lambda *shape, scale=0.5, shift=0.0: _rand(rng, device, dtype, *shape, scale=scale, shift=shift)  # noqa: E731
    params = [r(c, shift=1.0), r(c), r(c, 2 * c, scale=sc), r(2 * c), r(3, 3, 2 * c, scale=1 / 3), r(2 * c),
              r(c, c, scale=sc), r(c), r(c, c, scale=sc), r(c), r(c), r(c, shift=1.0), r(c), r(c, 2 * c, scale=sc),
              r(2 * c), r(c, c, scale=sc), r(c), r(c)]
    x = r(b, s, s, c, scale=1.0)
    ref = tnb.naf_block_ref(x.float(), *[p.float() for p in params])
    return (lambda: tnb._kernel_forward(x, params, 1e-6)), ref


def _held(launch, ref, dtype, limit=None) -> torch.Tensor:
    with torch.no_grad():
        got, again = launch(), launch()
    torch.cuda.synchronize()
    assert torch.equal(got, again), "two runs on the same inputs differ"
    assert got.shape == ref.shape and got.dtype == dtype and torch.isfinite(got).all()
    err = (got.float() - ref).abs().max().item() / max(1.0, ref.abs().max().item())
    assert err <= (limit or LIMIT[dtype]), err
    return got


# (C, H = W, heads, flavour, dtype) at B = 8: Restormer's two 128 x 128 stages, its latent
@pytest.mark.parametrize("c,s,heads,flavour,dtype", [
    (48, 128, 1, RELU, torch.float32), (96, 128, 1, SOFTMAX, torch.float32), (384, 16, 8, RELU, torch.float32),
    (48, 128, 1, SOFTMAX, torch.bfloat16),
], ids=["c48-relu-f32", "c96-softmax-f32", "c384-relu-f32", "c48-softmax-bf16"])
def test_k6_at_batch_8_matches_plain(cuda, c, s, heads, flavour, dtype):
    _held(*_k6_call(cuda, 8, s, c, heads, flavour, dtype), dtype)


# (C, H = W, dtype) at B = 8: NAFNet-w64's first and c = 512 stages of a 128 x 128 crop
@pytest.mark.parametrize("c,s,dtype", [(64, 128, torch.float32), (512, 16, torch.float32), (64, 128, torch.bfloat16)],
                         ids=["c64-f32", "c512-f32", "c64-bf16"])
def test_k1_at_batch_8_matches_plain(cuda, c, s, dtype):
    _held(*_k1_call(cuda, 8, s, c, dtype), dtype)


@pytest.mark.parametrize("kernel", ["K6", "K1"])
def test_products_run_on_the_tensor_cores(cuda, kernel):
    """One call's launches in order (torch.profiler): the four 1x1 products are
    ``tc_gemm_kernel<N>`` of their owner, and no SIMT product kernel is left."""
    if kernel == "K6":
        launch, owner = _k6_call(cuda, 8, 128, 48, 1, RELU, torch.float32)[0], 6
    else:
        launch, owner = _k1_call(cuda, 8, 128, 64, torch.float32)[0], 1
    with torch.no_grad():
        names = [name for name, _ in pass_split(launch)]
    assert names, "torch.profiler recorded no device time"
    assert sum(n.startswith(f"tc_gemm_kernel<{owner},") for n in names) == 4, names
    assert not [n for n in names if n.startswith(RETIRED)], names


@pytest.mark.parametrize("kernel", ["K4", "K5"])
def test_k4_k5_at_batch_8_on_the_tensor_cores(cuda, kernel):
    """K4 and K5 at the c = 512 stage (16 x 16) at batch 8, fp32, against their plain
    versions twice for equal bits; one call's launches in order are the passes
    they share with K1 (``naf_common.cuh``) under their own owner's number: LN,
    then K4's expand and gate, or K5's W4 and W5 (W5 cut along its depth at
    2048 rows, its chunks added by ``chunk_epi_kernel<5>``)."""
    c, dtype = 512, torch.float32
    rng = np.random.default_rng(c)
    r = lambda *shape, scale=0.5, shift=0.0: _rand(rng, cuda, dtype, *shape, scale=scale, shift=shift)  # noqa: E731
    x = r(8, 16, 16, c, scale=1.0)
    # the 1x1 and depthwise weights as the module passes them: views of PyTorch's layouts, no copies
    w1, w4, w5 = r(2 * c, c, scale=c ** -0.5).t(), r(2 * c, c, scale=c ** -0.5).t(), r(c, c, scale=c ** -0.5).t()
    wdw = r(2 * c, 3, 3, scale=1 / 3).permute(1, 2, 0)
    if kernel == "K4":
        params = [r(c, shift=1.0), r(c), w1, r(2 * c), wdw, r(2 * c)]
        launch, ref, owner = (lambda: tnpf.naf_prefix(x, *params)), tnpf.naf_prefix_ref(x, *params), 4
        want = ["ln_fwd_kernel", "tc_gemm_kernel", "naf_gate_kernel"]
    else:
        params = [r(c, shift=1.0), r(c), w4, r(2 * c), w5, r(c), r(c)]
        launch, ref, owner = (lambda: tnff.naf_ffn(x, *params)), tnff.naf_ffn_ref(x, *params), 5
        want = ["ln_fwd_kernel", "tc_gemm_kernel", "tc_gemm_kernel", "chunk_epi_kernel"]
    _held(launch, ref, dtype)
    with torch.no_grad():
        names = [name for name, _ in pass_split(launch)]
    assert [n.split("<")[0] for n in names] == want, names
    assert all(n.startswith(f"{w}<{owner},") for n, w in zip(names, want)), names


# (kernel, C, H = W, C_out, ln_bias, dtype) at B = 8: Restormer's enc1 qkv (BiasFree) and
# project_in (WithBias, PromptIR's flavour), K5' at NAFNet-w64's c = 512 stage
@pytest.mark.parametrize("kernel,c,s,c_out,ln_bias,dtype", [
    ("K14", 48, 128, 144, False, torch.float32), ("K14", 48, 128, 254, True, torch.bfloat16),
    ("K5'", 512, 16, 1024, True, torch.float32), ("K5'", 512, 16, 1024, True, torch.bfloat16),
], ids=["k14-qkv-biasfree-f32", "k14-project-in-withbias-bf16", "k5p-c512-f32", "k5p-c512-bf16"])
def test_k14_k5p_at_batch_8_one_launch(cuda, kernel, c, s, c_out, ln_bias, dtype):
    """K14 and K5' at batch 8 against their plain versions, twice for equal bits,
    with the weight as the module passes it (the transposed view of the (c_out,
    c) 1x1 weight, ``_ln_conv1x1``) and contiguous: equal bits; one call is one
    launch of ``ln_proj_kernel`` (no LayerNorm pass, no weight copy)."""
    rng = np.random.default_rng(c + c_out)
    r = lambda *shape, scale=0.5, shift=0.0: _rand(rng, cuda, dtype, *shape, scale=scale, shift=shift)  # noqa: E731
    x = r(8, s, s, c, scale=2.0, shift=0.5)
    ln_w, ln_b, view = r(c, shift=1.0), r(c), r(c_out, c, scale=c ** -0.5).t()
    eps = 1e-5 if kernel == "K14" else 1e-6
    if not ln_bias:
        ln_b = torch.zeros_like(ln_b)
    f32 = [t.float() for t in (x, ln_w, ln_b, view)]
    if kernel == "K14":
        call = lambda w: tlp.fused_ln_proj(x, ln_w, ln_b, w, eps, not ln_bias)  # noqa: E731
        ref = tlp.ln_proj_ref(*f32, eps, not ln_bias)
    else:
        b1 = r(c_out)
        call = lambda w: tnff.naf_expand(x, ln_w, ln_b, w, b1, eps)  # noqa: E731
        ref = tnff.naf_expand_ref(*f32, b1.float(), eps)
    got = _held(lambda: call(view), ref, dtype, 1e-5 if dtype == torch.float32 else None)
    with torch.no_grad():
        assert torch.equal(got, call(view.contiguous())), "the transposed view and the contiguous weight differ"
        names = [name for name, _ in pass_split(lambda: call(view))]
    assert len(names) == 1 and names[0].startswith("ln_proj_kernel<"), names
