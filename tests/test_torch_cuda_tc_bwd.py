"""K7 (the TransformerBlock backward) and K2 (the NAFBlock backward) on the card,
whose products and weight gradients run on the tensor cores
(``csrc/tc_gemm.cuh``): each at the train ymls' batch 8 against its plain
version, twice for equal bits, and its launches by pass.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU: a CUDA
kernel has no CPU mode.  The file imports neither JAX nor dcpt_tpu; from the
repo root:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda_tc_bwd.py

Limits, relative to max(1, max|ref|), as ``chip_smoke.py`` holds the kernels:
fp32 1e-3 (weight gradients sum over 131 k pixels in another order), bf16
2e-2 (the bf16 kernel against the plain version in fp32 on the same rounded
inputs).
"""

import numpy as np
import pytest
import torch

from dcpt_tpu_torch.ops import mdta_block as tmb
from dcpt_tpu_torch.ops import mdta_block_bwd as tmbb
from dcpt_tpu_torch.ops import naf_block as tnb
from dcpt_tpu_torch.ops import naf_block_bwd as tnbb
from dcpt_tpu_torch.tools.swin_ab import pass_split

pytestmark = pytest.mark.cuda

LIMIT = {torch.float32: 1e-3, torch.bfloat16: 2e-2}
RELU, SOFTMAX = (False, False, 1e-6), (True, True, 1e-5)  # K7's flavours: (use_softmax, ln_bias, eps)
# the passes that are products or weight gradients: K7's G, three P and four W; K2's F1, F2, A, L1 and four W
PRODUCTS = 8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rand(rng, device, dtype, *shape, scale=0.3, shift=0.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale + shift).astype(np.float32)).to(device, dtype)


def _k7_call(device, b, s, c, heads, flavour, dtype):
    """K7's inputs from K6's residuals: (launch, plain cotangents)."""
    rng = np.random.default_rng(c + s)
    f = int(c * 2.66)
    r = lambda *shape, **kw: _rand(rng, device, dtype, *shape, **kw)  # noqa: E731
    params = [r(c, shift=1.0), r(c), r(c, 3 * c, scale=c ** -0.5), r(3, 3, 3 * c, scale=1 / 3),
              r(heads, 1, 1, shift=1.0), r(c, c, scale=c ** -0.5), r(c, shift=1.0), r(c),
              r(c, 2 * f, scale=c ** -0.5), r(3, 3, 2 * f, scale=1 / 3), r(f, c, scale=f ** -0.5)]
    x, dz = r(b, s, s, c, scale=1.0), r(b, s, s, c, scale=1.0)
    _, res = tmb._kernel_forward(x, params, heads, *flavour, residuals=True)
    ref = tmbb.mdta_block_bwd_ref(x.float(), *[p.float() for p in params], *res[:4], dz.float(), heads, *flavour)
    return (lambda: tmbb.mdta_block_bwd(x, *params, dz, res, heads, *flavour)), ref


def _k2_call(device, b, s, c, dtype):
    """K2's inputs from K1's residuals: (launch, plain cotangents)."""
    rng = np.random.default_rng(c + s)
    sc = c ** -0.5
    r = lambda *shape, scale=0.5, shift=0.0: _rand(rng, device, dtype, *shape, scale=scale, shift=shift)  # noqa: E731
    params = [r(c, shift=1.0), r(c), r(c, 2 * c, scale=sc), r(2 * c), r(3, 3, 2 * c, scale=1 / 3), r(2 * c),
              r(c, c, scale=sc), r(c), r(c, c, scale=sc), r(c), r(c), r(c, shift=1.0), r(c), r(c, 2 * c, scale=sc),
              r(2 * c), r(c, c, scale=sc), r(c), r(c)]
    x, dz = r(b, s, s, c, scale=1.0), r(b, s, s, c, scale=1.0)
    _, (*maps, pooled, att) = tnb._kernel_forward(x, params, 1e-6, residuals=True)
    ref = tnbb.naf_block_bwd_ref(x.float(), *[p.float() for p in params], pooled, att, dz.float())
    return (lambda: tnbb.naf_block_bwd(x, *params, pooled, att, dz, maps)), ref


def _held(launch, ref, dtype) -> None:
    got, again = launch(), launch()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again)), "two runs on the same inputs differ"
    for i, (g, w) in enumerate(zip(got, ref, strict=True)):
        assert g.shape == w.shape and g.dtype == dtype and torch.isfinite(g).all(), i
        err = (g.float() - w.float()).abs().max().item() / max(1.0, w.float().abs().max().item())
        assert err <= LIMIT[dtype], (i, err)


# (C, H = W, heads, flavour, dtype) at B = 8: Restormer's two 128 x 128 stages as the train ymls run them
@pytest.mark.parametrize("c,s,heads,flavour,dtype", [
    (48, 128, 1, RELU, torch.float32), (96, 128, 1, SOFTMAX, torch.float32), (48, 128, 1, SOFTMAX, torch.bfloat16),
], ids=["c48-relu-f32", "c96-softmax-f32", "c48-softmax-bf16"])
def test_k7_at_batch_8_matches_plain(cuda, c, s, heads, flavour, dtype):
    _held(*_k7_call(cuda, 8, s, c, heads, flavour, dtype), dtype)


# (C, H = W, dtype) at B = 8: NAFNet-w64's first and c = 512 stages of a 128 x 128 crop
@pytest.mark.parametrize("c,s,dtype", [(64, 128, torch.float32), (512, 16, torch.float32), (64, 128, torch.bfloat16)],
                         ids=["c64-f32", "c512-f32", "c64-bf16"])
def test_k2_at_batch_8_matches_plain(cuda, c, s, dtype):
    _held(*_k2_call(cuda, 8, s, c, dtype), dtype)


@pytest.mark.parametrize("kernel", ["K7", "K2"])
def test_products_run_on_the_tensor_cores(cuda, kernel):
    """One call's launches in order (torch.profiler): every product and weight
    gradient is ``tc_gemm_kernel<N>`` of its owner, and no SIMT product is left."""
    if kernel == "K7":
        launch, owner = _k7_call(cuda, 8, 128, 48, 1, RELU, torch.float32)[0], 7
    else:
        launch, owner = _k2_call(cuda, 8, 128, 64, torch.float32)[0], 2
    names = [name for name, _ in pass_split(launch)]
    assert names, "torch.profiler recorded no device time"
    assert sum(n.startswith(f"tc_gemm_kernel<{owner},") for n in names) == PRODUCTS, names
    simt = ("k7_gate_kernel", "k7_prod_kernel", "wgrad_kernel", "bwd_f1_kernel", "bwd_prod_kernel", "bwd_a_kernel",
            "bwd_w_kernel")
    assert not [n for n in names if n.startswith(simt)], names
