"""Kernel K1's module in the PyTorch port (dcpt_tpu_torch/ops/naf_block.py)
against dcpt_tpu's whole-NAFBlock op, on the same seeded numpy inputs.

On the CPU the port's wrapper runs its plain twin; the CUDA kernel itself is
held against the twin in tests/test_torch_cuda.py, which skips without a card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import _torch_threads  # noqa: F401
from dcpt_tpu.ops.naf_block import naf_block_fused as jax_naf_block_fused
from dcpt_tpu.ops.naf_block import naf_block_ref as jax_naf_block_ref
from dcpt_tpu_torch.ops import naf_block as tnb


def block_inputs(b, h, w, c, seed=0):
    """x (B, H, W, C) and the 18 parameters in the op's layout; beta, gamma and
    the norm affines are random so the whole block body shows (at init the
    block is the identity)."""
    rng = np.random.default_rng(seed)

    def r(*shape, scale=0.5, shift=0.0):
        return (rng.standard_normal(shape) * scale + shift).astype(np.float32)

    s = c ** -0.5
    x = r(b, h, w, c, scale=1.0)
    params = [r(c, shift=1.0), r(c), r(c, 2 * c, scale=s), r(2 * c), r(3, 3, 2 * c, scale=1 / 3), r(2 * c),
              r(c, c, scale=s), r(c), r(c, c, scale=s), r(c), r(c), r(c, shift=1.0), r(c), r(c, 2 * c, scale=s),
              r(2 * c), r(c, c, scale=s), r(c), r(c)]
    return x, params


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_plain_twin_matches_jax_ref_and_interpreted_kernel():
    """fp32, B=2, H=16, W=8, C=8: max-abs <= 1e-5 against dcpt_tpu's jnp twin and
    against its Pallas kernel run in interpret mode (row tile 8)."""
    x, params = block_inputs(2, 16, 8, 8)
    ours = tnb.naf_block_ref(torch.from_numpy(x), *_torch(params)).numpy()
    jx = [jnp.asarray(a) for a in [x, *params]]
    ref = np.asarray(jax_naf_block_ref(*jx))
    kernel = np.asarray(jax_naf_block_fused(*jx, 1e-6, 8, True))
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(ours, kernel, atol=1e-5, rtol=0)


def test_cpu_wrapper_runs_the_twin_and_launches_nothing():
    x, params = block_inputs(2, 16, 8, 8, seed=1)
    xt, pt = torch.from_numpy(x), _torch(params)
    z = tnb.naf_block_fused(xt, *pt)
    assert tnb.naf_block_fused.launches == 0
    assert torch.equal(z, tnb.naf_block_ref(xt, *pt))


def test_wrapper_raises_on_a_device_without_a_kernel():
    x, params = block_inputs(1, 4, 4, 64)
    with pytest.raises(ValueError, match="no kernel"):
        tnb.naf_block_fused(torch.from_numpy(x).to("meta"), *[p.to("meta") for p in _torch(params)])


@pytest.mark.parametrize("case", ["noncontiguous", "channels", "dtype", "weight_shape", "weight_dtype"])
def test_kernel_input_checks_raise(case):
    """What the CUDA path refuses, checked before any launch."""
    x, params = block_inputs(1, 4, 6, 64)
    xt, pt = torch.from_numpy(x), _torch(params)
    if case == "noncontiguous":
        xt = xt.transpose(1, 2)
    elif case == "channels":
        x, params = block_inputs(1, 4, 6, 8)
        xt, pt = torch.from_numpy(x), _torch(params)
    elif case == "dtype":
        xt, pt = xt.double(), [p.double() for p in pt]
    elif case == "weight_shape":
        pt[2] = pt[2][:, :64]
    else:
        pt[6] = pt[6].bfloat16()
    with pytest.raises((ValueError, TypeError)):
        tnb._check(xt, pt)
    tnb._check(*block_inputs_torch())  # the unmodified inputs pass


def block_inputs_torch():
    x, params = block_inputs(1, 4, 6, 64)
    return torch.from_numpy(x), _torch(params)
