"""Kernel K3's module in the PyTorch port (dcpt_tpu_torch/ops/layernorm2d.py)
against dcpt_tpu's layer_norm_2d (its Pallas kernels in interpret mode) and
F.layer_norm, on the same seeded numpy inputs; and the LayerNorm2d module at
the kernel's gate against dcpt_tpu's, forward and gradients."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

import _torch_threads  # noqa: F401
from dcpt_tpu.archs.arch_util import LayerNorm2d as JaxLayerNorm2d
from dcpt_tpu.ops.layernorm2d import layer_norm_2d as jax_layer_norm_2d
from dcpt_tpu_torch.archs.arch_util import LayerNorm2d
from dcpt_tpu_torch.ops import layernorm2d as tln


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    return x, rng.standard_normal(c).astype(np.float32), rng.standard_normal(c).astype(np.float32), \
        rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(2, 4, 4, 512), (3, 2, 5, 1024)])
def test_plain_versions_match_jax_kernel_and_f_layer_norm(shape):
    """Forward and the analytic backward (gx, gw, gb), fp32: 1e-5 absolute on the
    output and gx, 1e-4 relative on the column sums gw and gb."""
    x, w, b, g = _inputs(shape, seed=shape[-1])
    out, y, rsig = tln.layer_norm_2d_ref(*map(torch.from_numpy, (x, w, b)), 1e-6)
    gx, gw, gb = tln.layer_norm_2d_bwd_ref(torch.from_numpy(g), y, rsig, torch.from_numpy(w))

    jx, jw, jb = jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)
    jout, vjp = jax.vjp(lambda *a: jax_layer_norm_2d(*a, 1e-6, True), jx, jw, jb)
    jgx, jgw, jgb = vjp(jnp.asarray(g))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5, rtol=0)
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), atol=1e-5, rtol=0)
    np.testing.assert_allclose(gw.numpy(), np.asarray(jgw), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(gb.numpy(), np.asarray(jgb), atol=1e-4, rtol=1e-4)

    xt, wt, bt = (torch.from_numpy(a).requires_grad_() for a in (x, w, b))
    F.layer_norm(xt, (shape[-1],), wt, bt, 1e-6).backward(torch.from_numpy(g))
    torch.testing.assert_close(out, F.layer_norm(torch.from_numpy(x), (shape[-1],), torch.from_numpy(w),
                                                 torch.from_numpy(b), 1e-6), atol=1e-5, rtol=0)
    torch.testing.assert_close(gx, xt.grad, atol=1e-5, rtol=0)
    torch.testing.assert_close(gw, wt.grad, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(gb, bt.grad, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("channels,through_function", [(512, True), (8192, True), (256, False)])
def test_module_routes_at_the_gate_and_matches_jax(channels, through_function):
    """LayerNorm2d at C = 512 and at C = 8192 (wider than K3 holds a row of in
    registers) runs layer_norm_2d's Function (on the CPU its plain versions), at
    C = 256 plain PyTorch; each gives dcpt_tpu's output and gradients within
    1e-5 / 1e-4."""
    x, w, b, g = _inputs((2, 3, 4, channels), seed=channels + 1)
    ln = LayerNorm2d(channels)
    assert ln.use_kernel == through_function
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(w))
        ln.bias.copy_(torch.from_numpy(b))
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).requires_grad_()
    out = ln(xt)
    assert (out.grad_fn.next_functions[0][0].name() == "LayerNorm2dFunctionBackward") == through_function
    out.backward(torch.from_numpy(g.transpose(0, 3, 1, 2).copy()))

    jln = JaxLayerNorm2d(channels)
    jout, vjp = jax.vjp(lambda p, a: jln.apply({"params": p}, a), {"weight": jnp.asarray(w), "bias": jnp.asarray(b)},
                        jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(g))
    np.testing.assert_allclose(out.detach().numpy().transpose(0, 2, 3, 1), np.asarray(jout), atol=1e-5, rtol=0)
    np.testing.assert_allclose(xt.grad.numpy().transpose(0, 2, 3, 1), np.asarray(jgx), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(ln.weight.grad.numpy(), np.asarray(jgp["weight"]), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(ln.bias.grad.numpy(), np.asarray(jgp["bias"]), atol=1e-4, rtol=1e-4)


def test_cpu_launches_nothing_and_other_devices_raise():
    x, w, b, _ = _inputs((1, 2, 2, 512), seed=0)
    before = (tln.layer_norm_2d.launches, tln.layer_norm_2d.bwd_launches)
    out = tln.layer_norm_2d(*map(torch.from_numpy, (x, w, b)))
    assert (tln.layer_norm_2d.launches, tln.layer_norm_2d.bwd_launches) == before
    assert torch.equal(out, tln.layer_norm_2d_ref(*map(torch.from_numpy, (x, w, b)), 1e-6)[0])
    with pytest.raises(ValueError, match="no kernel"):
        tln.layer_norm_2d(*(torch.from_numpy(a).to("meta") for a in (x, w, b)))


@pytest.mark.parametrize("shape", [(2, 3, 5, 512), (4, 2, 1024)])
def test_function_saves_stats_and_matches_jax_kernel(shape):
    """LayerNorm2dFunction keeps x, the mean and 1/sigma of each row and the
    weight, as F.layer_norm does (no y); the gradients it recomputes from them
    are dcpt_tpu's kernel's (interpret mode) within 1e-5 / 1e-4."""
    x, w, b, g = _inputs(shape, seed=shape[-1] + 7)
    xt, wt, bt = (torch.from_numpy(a).requires_grad_() for a in (x, w, b))
    out = tln.LayerNorm2dFunction.apply(xt, wt, bt, 1e-6)
    saved = out.grad_fn.saved_tensors
    assert [tuple(t.shape) for t in saved] == [shape, (*shape[:-1], 1), (*shape[:-1], 1), (shape[-1],)]
    assert torch.equal(saved[0], xt) and torch.equal(saved[3], wt)
    out.backward(torch.from_numpy(g))

    jout, vjp = jax.vjp(lambda *a: jax_layer_norm_2d(*a, 1e-6, True), jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    jgx, jgw, jgb = vjp(jnp.asarray(g))
    np.testing.assert_allclose(saved[1][..., 0].numpy(), x.mean(-1), atol=1e-5, rtol=0)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=1e-5, rtol=0)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), atol=1e-5, rtol=0)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jgw), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(jgb), atol=1e-4, rtol=1e-4)
