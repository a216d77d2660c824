"""Kernel K7's module in the PyTorch port (dcpt_tpu_torch/ops/mdta_block_bwd.py)
against dcpt_tpu's analytic TransformerBlock backward, on the same seeded numpy inputs.

``mdta_block_bwd_ref`` is the plain version the CUDA kernel is held to on the
card (tests/test_torch_cuda.py) and in the CPU emulation
(tests/test_torch_mdta_emu.py); here it is held to dcpt_tpu's Pallas backward
run in interpret mode (given the residuals of its forward kernel) and to
``jax.vjp`` of dcpt_tpu's twin, on all 12 cotangents, with the tolerance of
dcpt_tpu's own test (atol = rtol = 2e-4, tests/test_ops.py:800-803).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _torch_threads  # noqa: F401
from dcpt_tpu.ops.mdta_block import _block_pallas as jax_block_pallas
from dcpt_tpu.ops.mdta_block import mdta_block_ref as jax_mdta_block_ref
from dcpt_tpu.ops.mdta_block_bwd import mdta_block_bwd as jax_mdta_block_bwd
from dcpt_tpu_torch.ops import mdta_block as tmb
from dcpt_tpu_torch.ops import mdta_block_bwd as tmbb
from test_torch_mdta_block import FLAVOURS, HEADS, block_inputs


def _case(b, h, w, seed):
    x, params = block_inputs(b, h, w, seed=seed)
    dz = np.random.default_rng(seed + 100).standard_normal(x.shape).astype(np.float32)
    return x, params, dz


def _jax_vjp(x, params, dz, flavour):
    _, vjp = jax.vjp(lambda *a: jax_mdta_block_ref(*a, HEADS, *flavour), *[jnp.asarray(a) for a in [x, *params]])
    return [np.asarray(g) for g in vjp(jnp.asarray(dz))]


def _port_ref(x, params, dz, flavour, res=None):
    """The plain backward, from the port's own forward residuals or from ``res``
    = (gram (B, C, C), qn2, kn2, attn) of dcpt_tpu's forward kernel."""
    xt, pt = torch.from_numpy(x), [torch.from_numpy(p) for p in params]
    if res is None:
        res = tmb._ref_forward(xt, *pt, HEADS, *flavour)[1]
    else:
        gram, qn2, kn2, attn = (torch.from_numpy(np.array(r)) for r in res)
        res = (tmb.head_blocks(gram, HEADS), qn2, kn2, attn)
    grads = tmbb.mdta_block_bwd_ref(xt, *pt, *res, torch.from_numpy(dz), HEADS, *flavour)
    return [g.numpy() for g in grads]


def _assert_all(ours, ref, what):
    assert len(ours) == len(ref) == 12
    for i, (a, b) in enumerate(zip(ours, ref)):
        assert a.shape == b.shape, (what, i, a.shape, b.shape)
        np.testing.assert_allclose(a, b, atol=2e-4, rtol=2e-4, err_msg=f"{what}: cotangent {i}")


# (B, H, W) and dcpt_tpu's backward row tile: two tiles (Restormer's flavour), and
# the whole map in one tile (PromptIR's)
@pytest.mark.parametrize("shape,th,flavour", [((2, 16, 8), 8, FLAVOURS[0]), ((1, 8, 8), 8, FLAVOURS[1])])
def test_plain_backward_matches_jax_kernel(shape, th, flavour):
    """C = 12, 3 heads: against dcpt_tpu's Pallas backward (interpret, given the
    residuals of its forward kernel)."""
    x, params, dz = _case(*shape, seed=th + shape[0])
    jx = [jnp.asarray(a) for a in [x, *params]]
    _, v, gram, qn2, kn2, attn = jax_block_pallas(*jx, HEADS, *flavour, th, True, None, with_res=True)
    kernel = jax_mdta_block_bwd(*jx, v, gram, qn2, kn2, attn, jnp.asarray(dz), HEADS, *flavour, th, interpret=True)
    _assert_all(_port_ref(x, params, dz, flavour, (gram, qn2, kn2, attn)), [np.asarray(g) for g in kernel],
                f"interpret th={th}")


@pytest.mark.parametrize("flavour", FLAVOURS)
def test_plain_backward_matches_vjp_on_a_ragged_map(flavour):
    """H = 5, W = 7: no row tile divides the map, so dcpt_tpu's kernel would
    delegate; the plain version (and K7) take it, held to jax.vjp of
    dcpt_tpu's twin."""
    x, params, dz = _case(1, 5, 7, seed=3)
    _assert_all(_port_ref(x, params, dz, flavour), _jax_vjp(x, params, dz, flavour), "jax.vjp ragged")


@pytest.mark.parametrize("flavour", FLAVOURS)
def test_function_gradients_match_autograd_of_the_plain_forward(flavour):
    """Through MDTABlockFunction on the CPU (plain forward, plain K7) against
    torch.autograd of mdta_block_ref: x and all 11 parameters, 1e-4; nothing launches."""
    x, params, dz = _case(2, 6, 5, seed=9)

    def grads(fn):
        xt = torch.from_numpy(x).requires_grad_()
        pt = [torch.from_numpy(p).requires_grad_() for p in params]
        z = fn(xt, *pt, HEADS, *flavour)
        z.backward(torch.from_numpy(dz))
        return z, [xt.grad] + [p.grad for p in pt]

    before = (tmb.mdta_block_fused.launches, tmbb.mdta_block_bwd.launches)
    z, ours = grads(tmb.mdta_block_fused)
    assert type(z.grad_fn).__name__ == "MDTABlockFunctionBackward"
    _, ref = grads(tmb.mdta_block_ref)
    assert (tmb.mdta_block_fused.launches, tmbb.mdta_block_bwd.launches) == before
    for i, (a, b) in enumerate(zip(ours, ref)):
        b = torch.zeros_like(a) if b is None else b  # BiasFree: the LN biases reach nothing
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4, msg=f"cotangent {i}")


def test_head_blocks_and_cspace_step():
    """head_blocks keeps each row's head block; the C-space step's dgram is zero off them."""
    rng = np.random.default_rng(4)
    full = torch.from_numpy(rng.standard_normal((2, 12, 12)).astype(np.float32))
    blocks = tmb.head_blocks(full, 3)
    assert blocks.shape == (2, 12, 4)
    torch.testing.assert_close(blocks[:, 4:8], full[:, 4:8, 4:8])
    qn2, kn2 = (torch.from_numpy(rng.uniform(0.5, 3, (2, 12)).astype(np.float32)) for _ in range(2))
    temp = torch.ones(3, 1, 1)
    attn = tmb.attn_from_stats(full, qn2, kn2, temp, 3, True)
    dgram, *_ = tmbb.cspace_bwd_ref(torch.ones(2, 12, 12), attn, blocks, qn2, kn2, temp, 3, True)
    assert not dgram[:, :4, 4:].any() and dgram.shape == (2, 12, 12)


def test_kernel_wrapper_checks_its_inputs():
    """What the CUDA path refuses, checked before any launch: residuals of the wrong
    shape or number, and a dtype mix (bf16 x and parameters take a bf16 dz and fp32 residuals)."""
    x, params = block_inputs(1, 4, 6)
    xt, pt = torch.from_numpy(x), [torch.from_numpy(p) for p in params]
    b, h, w, c = x.shape
    f, ch = params[-1].shape[0], c // HEADS
    res = [torch.zeros(b, c, ch), torch.zeros(b, c), torch.zeros(b, c), torch.zeros(b, c, c)]
    res += [torch.zeros(b, h, w, k) for k in (3 * c, 3 * c, c, c, 2 * f, f)]
    dz = torch.zeros_like(xt)
    tmbb._check(xt, pt, dz, res, HEADS)
    with pytest.raises(ValueError, match="u is"):
        tmbb._check(xt, pt, dz, res[:8] + [torch.zeros(b, h, w, f)] + res[9:], HEADS)
    with pytest.raises(ValueError, match="residuals"):
        tmbb._check(xt, pt, dz, res[:4], HEADS)
    tmbb._check(xt.bfloat16(), [p.bfloat16() for p in pt], dz.bfloat16(), res, HEADS)
    with pytest.raises(TypeError, match="dz is"):
        tmbb._check(xt.bfloat16(), [p.bfloat16() for p in pt], dz, res, HEADS)
    with pytest.raises(TypeError, match="attn is"):
        tmbb._check(xt.bfloat16(), [p.bfloat16() for p in pt], dz.bfloat16(), res[:3] + [res[3].bfloat16()] + res[4:],
                    HEADS)
    with pytest.raises(TypeError):
        tmbb._check(xt.bfloat16(), pt, dz.bfloat16(), res, HEADS)
