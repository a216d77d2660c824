"""The port's standalone ops (K11 window partition / reverse, K12 fused bias +
LeakyReLU, K13 MDTA attention, K14 LN + projection, K5' naf_expand) against
dcpt_tpu on the CPU.

The same seeded numpy inputs go through dcpt_tpu's public function and the
port's.  In fp32 dcpt_tpu's Pallas kernels run in interpret mode (as
``tests/test_ops.py`` runs them), and every autograd Function's gradients are
held to ``jax.vjp`` of dcpt_tpu's function on the same cotangent.  In bf16 the
port's plain versions are held to dcpt_tpu's kernels (K11, K12) or to their
jnp twins (``mdta_ref``, ``ln_proj_ref``, ``naf_expand_ref``).  The CUDA
kernels themselves are held to the plain versions on the card
(``tests/test_torch_cuda.py``) and under the CPU emulation
(``tests/test_torch_standalone_emu.py``).

Tolerances, relative to max(1, max|ref|): the window ops are copies, exact
(atol 0); fp32 forwards 1e-5 and fp32 gradients 1e-4 (sums in another order,
through the L2 norm's and the LayerNorm's cancellations); bf16 2e-2 (a few
bf16 roundings of order 4e-3 that the two frameworks take at other places).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dcpt_tpu.archs.swinir_arch import window_partition as jax_window_partition
from dcpt_tpu.ops import fused_act as jax_fa
from dcpt_tpu.ops import ln_proj as jax_lp
from dcpt_tpu.ops import mdta as jax_mdta
from dcpt_tpu.ops import naf_ffn as jax_ffn
from dcpt_tpu.ops import window_process as jax_wp
from dcpt_tpu_torch import ops
from dcpt_tpu_torch.ops import ln_proj, mdta, naf_ffn, window_process

FWD, GRAD, BF16 = 1e-5, 1e-4, 2e-2


def _close(ours: torch.Tensor, ref, tol: float, name: str) -> None:
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    got = ours.detach().float().numpy()
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * max(1.0, np.abs(ref).max()), err_msg=name)


def _grads_close(torch_fn, jax_fn, arrays: list[np.ndarray], cot: np.ndarray, names: list[str], tol: float = GRAD):
    """The port's gradients (autograd through ``torch_fn``) against ``jax.vjp`` of
    ``jax_fn`` on the same inputs and cotangent; an unused input's gradient (None
    in torch) is held to zeros."""
    ts = [torch.from_numpy(a.copy()).requires_grad_() for a in arrays]
    torch_fn(*ts).backward(torch.from_numpy(cot))
    _, vjp = jax.vjp(jax_fn, *[jnp.asarray(a) for a in arrays])
    for t, ref, name in zip(ts, vjp(jnp.asarray(cot)), names):
        _close(t.grad if t.grad is not None else torch.zeros_like(t), ref, tol, f"d{name}")


def _r(rng, *shape, scale=1.0, shift=0.0):
    return (rng.standard_normal(shape) * scale + shift).astype(np.float32)


@pytest.mark.parametrize("shift", [0, 2])
def test_window_process_matches_dcpt_tpu(shift):
    """K11 in fp32, bit for bit: the partition against dcpt_tpu's Pallas kernel
    and against swinir_arch's roll + window_partition; the reverse against
    dcpt_tpu's and as the partition's inverse.  A ragged map and an input that
    records a graph raise."""
    x = _r(np.random.default_rng(shift), 2, 8, 8, 16)
    ours = ops.window_partition_fused(torch.from_numpy(x), 4, shift)
    ref = jax_wp.window_partition_fused(jnp.asarray(x), 4, shift, interpret=True)
    rolled = jnp.roll(jnp.asarray(x), (-shift, -shift), (1, 2)) if shift else jnp.asarray(x)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(jax_window_partition(rolled, 4)))
    back = ops.window_reverse_fused(ours, 4, 8, 8, shift)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jax_wp.window_reverse_fused(ref, 4, 8, 8, shift, True)))
    np.testing.assert_array_equal(back.numpy(), x)
    with pytest.raises(ValueError, match="multiples of window_size"):
        ops.window_partition_fused(torch.zeros(1, 10, 8, 3), 4, shift)
    with pytest.raises(ValueError, match="multiples of window_size"):
        ops.window_reverse_fused(torch.zeros(4, 16, 3), 4, 8, 6, shift)
    with pytest.raises(RuntimeError, match="no gradient"):
        ops.window_partition_fused(torch.zeros(1, 8, 8, 3, requires_grad=True), 4, shift)
    with torch.no_grad():  # no graph to cut
        assert ops.window_partition_fused(torch.zeros(1, 8, 8, 3, requires_grad=True), 4, shift).shape == (4, 16, 3)


def test_fused_act_matches_dcpt_tpu():
    """K12 in fp32: the forward against dcpt_tpu's Pallas kernel; gx and gb against
    its custom VJP (the Pallas backward).  One pixel sits at x + b == 0, where the
    strict mask gives the slope: gx = slope * scale * g there."""
    rng = np.random.default_rng(3)
    x, b, g = _r(rng, 2, 4, 4, 8), _r(rng, 8, scale=0.2), _r(rng, 2, 4, 4, 8)
    x[0, 1, 2] = -b
    ours = ops.fused_bias_leaky_relu(torch.from_numpy(x), torch.from_numpy(b))
    _close(ours, jax_fa.fused_bias_leaky_relu(jnp.asarray(x), jnp.asarray(b), 0.2, 2 ** 0.5, True), FWD, "out")
    _grads_close(ops.fused_bias_leaky_relu, lambda x, b: jax_fa.fused_bias_leaky_relu(x, b, 0.2, 2 ** 0.5, True),
                 [x, b], g, ["x", "b"])
    xt = torch.from_numpy(x).requires_grad_()
    ops.fused_bias_leaky_relu(xt, torch.from_numpy(b)).backward(torch.from_numpy(g))
    np.testing.assert_allclose(xt.grad[0, 1, 2].numpy(), 0.2 * 2 ** 0.5 * g[0, 1, 2], rtol=1e-6)


@pytest.mark.parametrize("use_softmax", [False, True])
def test_mdta_attention_matches_dcpt_tpu(use_softmax):
    """K13 in fp32 at L = 128 (dcpt_tpu's single-shot Pallas kernel): the forward;
    the gradients of q, k, v and the temperature against dcpt_tpu's custom VJP,
    the temperature as (BH,) for ReLU and (BH, 1, 1) for softmax, its cotangent
    in the caller's shape."""
    rng = np.random.default_rng(4 + use_softmax)
    q, k, v, g = (_r(rng, 4, 16, 128) for _ in range(4))
    t = (rng.random(4) + 0.5).astype(np.float32).reshape((4, 1, 1) if use_softmax else (4,))
    ours = ops.mdta_attention(*(torch.from_numpy(a) for a in (q, k, v, t)), use_softmax)
    _close(ours, jax_mdta.mdta_attention(*(jnp.asarray(a) for a in (q, k, v, t)), use_softmax, True), FWD, "out")
    _grads_close(lambda *a: ops.mdta_attention(*a, use_softmax),
                 lambda *a: jax_mdta.mdta_attention(*a, use_softmax, True), [q, k, v, t], g, ["q", "k", "v", "t"])


@pytest.mark.parametrize("biasfree", [True, False])
def test_fused_ln_proj_matches_dcpt_tpu(biasfree):
    """K14 in fp32, Restormer's qkv width (48 -> 144), eps 1e-5: the forward against
    dcpt_tpu's Pallas kernel; the gradients of x, the LayerNorm's weight and bias
    and w against its custom VJP (BiasFree: ln_b's is zero in both)."""
    rng = np.random.default_rng(6 + biasfree)
    x, g = _r(rng, 2, 8, 8, 48, shift=0.5), _r(rng, 2, 8, 8, 144)
    ln_w, w = _r(rng, 48, scale=0.1, shift=1.0), _r(rng, 48, 144, scale=0.05)
    ln_b = np.zeros(48, np.float32) if biasfree else _r(rng, 48, scale=0.1)
    args = [x, ln_w, ln_b, w]
    ours = ops.fused_ln_proj(*(torch.from_numpy(a) for a in args), 1e-5, biasfree)
    _close(ours, jax_lp.fused_ln_proj(*(jnp.asarray(a) for a in args), 1e-5, biasfree, True), FWD, "out")
    _grads_close(lambda *a: ops.fused_ln_proj(*a, 1e-5, biasfree),
                 lambda *a: jax_lp.fused_ln_proj(*a, 1e-5, biasfree, True), args, g, ["x", "ln_w", "ln_b", "w"])


def test_naf_expand_matches_dcpt_tpu():
    """K5' in fp32 at c = 128 -> 256 (tests/test_ops.py's shape): the forward against
    dcpt_tpu's Pallas kernel; the gradients of x, ln_w, ln_b, w1 and b1 against
    its custom VJP."""
    rng = np.random.default_rng(8)
    x, g = _r(rng, 2, 8, 8, 128), _r(rng, 2, 8, 8, 256)
    args = [x, _r(rng, 128, scale=0.1, shift=1.0), _r(rng, 128, scale=0.1), _r(rng, 128, 256, scale=0.05),
            _r(rng, 256, scale=0.05)]
    ours = ops.naf_expand(*(torch.from_numpy(a) for a in args))
    _close(ours, jax_ffn.naf_expand(*(jnp.asarray(a) for a in args), 1e-6, True), FWD, "out")
    _grads_close(ops.naf_expand, lambda *a: jax_ffn.naf_expand(*a, 1e-6, True), args, g,
                 ["x", "ln_w", "ln_b", "w1", "b1"])


def _bf16(arrays):
    return [torch.from_numpy(a).to(torch.bfloat16) for a in arrays], [jnp.asarray(a, jnp.bfloat16) for a in arrays]


@pytest.mark.parametrize("op", ["window_act", "mdta", "ln_proj", "naf_expand"])
def test_bf16_plain_versions_match_dcpt_tpu(op):
    """The plain versions in bf16 on the same bf16 inputs: K11 bit for bit and K12
    (forward, gx and gb) against dcpt_tpu's Pallas kernels; K13, K14 (both
    flavours) and K5' against dcpt_tpu's jnp twins."""
    rng = np.random.default_rng(10)
    if op == "window_act":
        x, b, g = _r(rng, 2, 8, 8, 16), _r(rng, 16, scale=0.2), _r(rng, 2, 8, 8, 16)
        (xt, bt, gt), (xj, bj, gj) = _bf16([x, b, g])
        win = window_process.window_partition_fused(xt, 4, 2)
        assert win.dtype == torch.bfloat16
        np.testing.assert_array_equal(win.float().numpy(),
                                      np.asarray(jax_wp.window_partition_fused(xj, 4, 2, True), np.float32))
        xt.requires_grad_(), bt.requires_grad_()
        out = ops.fused_bias_leaky_relu(xt, bt)
        out.backward(gt)
        ref, vjp = jax.vjp(lambda x, b: jax_fa.fused_bias_leaky_relu(x, b, 0.2, 2 ** 0.5, True), xj, bj)
        assert out.dtype == xt.grad.dtype == bt.grad.dtype == torch.bfloat16
        for got, want, name in zip([out, xt.grad, bt.grad], [ref, *vjp(gj)], ["out", "dx", "db"]):
            _close(got, want, BF16, name)
    elif op == "mdta":
        for use_softmax in (False, True):
            arrays = [_r(rng, 4, 16, 128) for _ in range(3)] + [(rng.random(4) + 0.5).astype(np.float32)]
            ts, js = _bf16(arrays)
            _close(mdta.mdta_attention(*ts, use_softmax), jax_mdta.mdta_ref(*js, use_softmax), BF16,
                   f"softmax={use_softmax}")
    elif op == "ln_proj":
        for biasfree in (True, False):
            arrays = [_r(rng, 2, 8, 8, 48, shift=0.5), _r(rng, 48, scale=0.1, shift=1.0),
                      np.zeros(48, np.float32) if biasfree else _r(rng, 48, scale=0.1), _r(rng, 48, 144, scale=0.05)]
            ts, js = _bf16(arrays)
            got = ln_proj.fused_ln_proj(*ts, 1e-6, biasfree)
            ref = jax_lp.ln_proj_ref(js[0].reshape(-1, 48), *js[1:], 1e-6, biasfree).reshape(2, 8, 8, 144)
            assert got.dtype == torch.bfloat16
            _close(got, ref, BF16, f"biasfree={biasfree}")
    else:
        arrays = [_r(rng, 2, 8, 8, 128), _r(rng, 128, scale=0.1, shift=1.0), _r(rng, 128, scale=0.1),
                  _r(rng, 128, 256, scale=0.05), _r(rng, 256, scale=0.05)]
        ts, js = _bf16(arrays)
        got = naf_ffn.naf_expand(*ts)
        _close(got, jax_ffn.naf_expand_ref(js[0].reshape(-1, 128), *js[1:]).reshape(2, 8, 8, 256), BF16, "out")
