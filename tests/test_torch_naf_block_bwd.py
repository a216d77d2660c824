"""Kernel K2's module in the PyTorch port (dcpt_tpu_torch/ops/naf_block_bwd.py)
against dcpt_tpu's analytic NAFBlock backward, on the same seeded numpy inputs.

``naf_block_bwd_ref`` is the plain version the CUDA kernel is held to on the
card (tests/test_torch_cuda.py); here it is held to dcpt_tpu's Pallas backward
run in interpret mode and to ``jax.vjp`` of dcpt_tpu's twin, on all 19
cotangents, with the tolerance of dcpt_tpu's own test (atol = rtol = 2e-4,
tests/test_ops.py:668-670).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _torch_threads  # noqa: F401
from dcpt_tpu.ops.naf_block import naf_block_ref as jax_naf_block_ref
from dcpt_tpu.ops.naf_block_bwd import naf_block_bwd as jax_naf_block_bwd
from dcpt_tpu_torch.ops import naf_block as tnb
from dcpt_tpu_torch.ops import naf_block_bwd as tnbb
from test_torch_naf_block import block_inputs


def _case(b, h, w, c, seed):
    x, params = block_inputs(b, h, w, c, seed=seed)
    dz = np.random.default_rng(seed + 100).standard_normal(x.shape).astype(np.float32)
    return x, params, dz


def _jax_vjp(x, params, dz):
    args = [jnp.asarray(a) for a in [x, *params]]
    _, vjp = jax.vjp(lambda *a: jax_naf_block_ref(*a, 1e-6), *args)
    return [np.asarray(g) for g in vjp(jnp.asarray(dz))]


def _port_ref(x, params, dz):
    xt, pt = torch.from_numpy(x), [torch.from_numpy(p) for p in params]
    _, pooled, att = tnb._ref_forward(xt, *pt, 1e-6)
    return [g.numpy() for g in tnbb.naf_block_bwd_ref(xt, *pt, pooled, att, torch.from_numpy(dz))], pooled, att


def _assert_all(ours, ref, what):
    assert len(ours) == len(ref) == 19
    for i, (a, b) in enumerate(zip(ours, ref)):
        np.testing.assert_allclose(a, b, atol=2e-4, rtol=2e-4, err_msg=f"{what}: cotangent {i}")


@pytest.mark.parametrize("th", [8, 16])
def test_plain_backward_matches_jax_kernel_and_vjp(th):
    """B = 2, H = 16, W = 8, C = 8: against dcpt_tpu's Pallas backward (interpret,
    row tile th, given the same pooled / att) and against jax.vjp of its twin."""
    x, params, dz = _case(2, 16, 8, 8, seed=th)
    ours, pooled, att = _port_ref(x, params, dz)
    jargs = [jnp.asarray(a) for a in [x, *params]]
    kernel = jax_naf_block_bwd(*jargs, jnp.asarray(pooled.numpy()), jnp.asarray(att.numpy()), jnp.asarray(dz),
                               1e-6, th, interpret=True)
    _assert_all(ours, [np.asarray(g) for g in kernel], f"interpret th={th}")
    _assert_all(ours, _jax_vjp(x, params, dz), "jax.vjp")


def test_plain_backward_matches_vjp_on_a_ragged_map():
    """H = 5, W = 7: no row tile divides the map, so dcpt_tpu's kernel would
    delegate; the plain version (and K2) take it, held to jax.vjp."""
    x, params, dz = _case(1, 5, 7, 8, seed=3)
    ours, _, _ = _port_ref(x, params, dz)
    _assert_all(ours, _jax_vjp(x, params, dz), "jax.vjp ragged")


def test_function_gradients_match_autograd_of_the_twin():
    """Through the port's autograd Function on the CPU (plain forward, plain K2)
    against torch.autograd of naf_block_ref: x and all 18 parameters, 1e-4."""
    x, params, dz = _case(2, 6, 10, 8, seed=9)

    def grads(fn):
        xt = torch.from_numpy(x).requires_grad_()
        pt = [torch.from_numpy(p).requires_grad_() for p in params]
        fn(xt, *pt).backward(torch.from_numpy(dz))
        return [xt.grad] + [p.grad for p in pt]

    before = tnbb.naf_block_bwd.launches
    ours = grads(tnb.naf_block_fused)
    ref = grads(tnb.naf_block_ref)
    assert tnbb.naf_block_bwd.launches == before  # the CPU runs the plain version
    for i, (a, b) in enumerate(zip(ours, ref)):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4, msg=f"cotangent {i}")


def test_kernel_wrapper_checks_its_inputs():
    """What the CUDA path refuses, checked before any launch: residuals of the wrong
    shape, and a dtype mix it does not take (bf16 x with fp32 dz and g); bf16 x,
    dz, g and parameters with fp32 residuals are what a bf16 K1 writes, and pass."""
    x, params = block_inputs(1, 4, 6, 64)
    xt, pt = torch.from_numpy(x), [torch.from_numpy(p) for p in params]
    b, h, w, c = x.shape
    maps = [torch.zeros(b, h, w, k * c) for k in (1, 2, 1, 1, 2, 1)]
    good = [xt, xt, *maps, torch.zeros(b, c), torch.zeros(b, c)]
    tnbb._check(xt, pt, good)
    with pytest.raises(ValueError, match="t is"):
        tnbb._check(xt, pt, good[:3] + [torch.zeros(b, h, w, c)] + good[4:])
    with pytest.raises(TypeError):
        tnbb._check(xt.bfloat16(), [p.bfloat16() for p in pt], good)
    tnbb._check(xt.bfloat16(), [p.bfloat16() for p in pt], [xt.bfloat16(), xt.bfloat16(), maps[0].bfloat16(),
                                                            *good[3:]])
