"""Kernel K6's module in the PyTorch port (dcpt_tpu_torch/ops/mdta_block.py)
against dcpt_tpu's whole-TransformerBlock op, on the same seeded numpy inputs.

On the CPU the port's wrapper runs its plain version; the CUDA kernel itself is
held against that version in tests/test_torch_cuda.py (on the card) and, built
by the CPU emulation of the CUDA runtime, in tests/test_torch_cuda_emu.py.  The
wrapper's checks and launch counting are in tests/test_torch_mdta_block_wrapper.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dcpt_tpu.ops.mdta_block import _attn_from_stats as jax_attn_from_stats
from dcpt_tpu.ops.mdta_block import _block_pallas as jax_block_pallas
from dcpt_tpu.ops.mdta_block import mdta_block_ref as jax_mdta_block_ref
from dcpt_tpu_torch.ops import mdta_block as tmb

# (use_softmax, ln_bias, eps): Restormer's flavour, then PromptIR's
FLAVOURS = [(False, False, 1e-6), (True, True, 1e-5)]
HEADS = 3


def block_inputs(b, h, w, c=12, heads=HEADS, seed=0):
    """x (B, H, W, C) and the 11 parameters in the op's layout, at the sizes of
    dcpt_tpu's ``TestMDTABlockFused._args`` (F = int(2.66 C)), with weights of
    unit gain (std 1/sqrt(fan-in)) so that every branch of the block shows in z."""
    rng = np.random.default_rng(seed)
    f = int(c * 2.66)

    def r(*shape, scale=0.3, shift=0.0):
        return (rng.standard_normal(shape) * scale + shift).astype(np.float32)

    x = r(b, h, w, c, scale=1.0)
    params = [r(c, shift=1.0), r(c), r(c, 3 * c, scale=c ** -0.5), r(3, 3, 3 * c, scale=1 / 3),
              r(heads, 1, 1, shift=1.0), r(c, c, scale=c ** -0.5), r(c, shift=1.0), r(c),
              r(c, 2 * f, scale=c ** -0.5), r(3, 3, 2 * f, scale=1 / 3), r(f, c, scale=f ** -0.5)]
    return x, params


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


# (B, H, W) and dcpt_tpu's row tile: its test's map, and a ragged map in one tile
@pytest.mark.parametrize("shape,th", [((2, 16, 8), 8), ((1, 5, 7), 5)])
@pytest.mark.parametrize("use_softmax,ln_bias,eps", FLAVOURS)
def test_plain_version_matches_jax_ref_and_interpreted_kernel(shape, th, use_softmax, ln_bias, eps):
    """fp32: max-abs <= 5e-5 (dcpt_tpu's own bar for its kernel) against its
    jnp twin and its Pallas kernel in interpret mode; the two differ in the
    GELU's erf (Abramowitz-Stegun in dcpt_tpu, exact here) by about 1e-7."""
    x, params = block_inputs(*shape)
    ours = tmb.mdta_block_ref(torch.from_numpy(x), *_torch(params), HEADS, use_softmax, ln_bias, eps).numpy()
    jx = [jnp.asarray(a) for a in [x, *params]]
    ref = np.asarray(jax_mdta_block_ref(*jx, HEADS, use_softmax, ln_bias, eps))
    kernel = np.asarray(jax_block_pallas(*jx, HEADS, use_softmax, ln_bias, eps, th, True))
    np.testing.assert_allclose(ours, ref, atol=5e-5, rtol=0)
    np.testing.assert_allclose(ours, kernel, atol=5e-5, rtol=0)
    assert np.abs(ours - x).max() > 0.1  # the block does change its input


@pytest.mark.parametrize("use_softmax", [False, True])
def test_attn_from_stats_matches_jax(use_softmax):
    rng = np.random.default_rng(5)
    b, c, heads = 2, 12, 3
    gram = rng.standard_normal((b, c, c)).astype(np.float32) * 4
    qn2, kn2 = (rng.uniform(0.5, 30, (b, c)).astype(np.float32) for _ in range(2))
    qn2[0, 1] = 0.0  # F.normalize's eps: a zero norm divides by 1e-12
    temperature = rng.uniform(0.5, 2, (heads, 1, 1)).astype(np.float32)
    ours = tmb.attn_from_stats(*_torch([gram, qn2, kn2, temperature]), heads, use_softmax).numpy()
    ref = np.asarray(jax_attn_from_stats(*map(jnp.asarray, [gram, qn2, kn2, temperature]), heads, use_softmax))
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("use_softmax,ln_bias,eps", FLAVOURS)
def test_cpu_wrapper_is_differentiable_and_matches_jax_gradients(use_softmax, ln_bias, eps):
    """Under autograd on the CPU the wrapper is the plain version: its gradients
    of x and all 11 parameters match jax.vjp of dcpt_tpu's jnp twin."""
    x, params = block_inputs(1, 6, 5, seed=2)
    dz = np.random.default_rng(3).standard_normal(x.shape).astype(np.float32)
    inputs = [t.requires_grad_() for t in _torch([x, *params])]
    z = tmb.mdta_block_fused(*inputs, HEADS, use_softmax, ln_bias, eps)
    assert z.grad_fn is not None and tmb.mdta_block_fused.launches == 0
    z.backward(torch.from_numpy(dz))
    _, vjp = jax.vjp(lambda *a: jax_mdta_block_ref(*a, HEADS, use_softmax, ln_bias, eps),
                     *[jnp.asarray(a) for a in [x, *params]])
    for i, (t, ref) in enumerate(zip(inputs, vjp(jnp.asarray(dz)))):
        ref = np.asarray(ref)
        got = np.zeros_like(ref) if t.grad is None else t.grad.numpy()  # BiasFree reads no LN bias
        np.testing.assert_allclose(got, ref, atol=2e-4 * max(1.0, np.abs(ref).max()), rtol=0, err_msg=f"input {i}")
