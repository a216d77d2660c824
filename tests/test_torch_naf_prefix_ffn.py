"""K4 (``naf_prefix``) and K5 (``naf_ffn``) of the PyTorch port against dcpt_tpu, on the CPU.

The plain versions beside the CUDA kernels are held against dcpt_tpu's Pallas
kernels run in interpret mode (as ``tests/test_ops.py`` runs them), in fp32 and
bf16; the autograd Functions' gradients against the plain versions'; and a
tiny NAFNetBaseline on the route that ``DCPT_TPU_PALLAS=1
DCPT_TPU_NAF_BLOCK=0`` selects (the module path, K4 and K5 at the c = 512
middle block) against dcpt_tpu's net in its ``all`` mode with the whole-block
kernel off, on the same converted weights.  The CUDA kernels themselves are
held to the plain versions on the card (``tests/test_torch_cuda.py``) and under
the CPU emulation (``tests/test_torch_naf_emu.py``).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dcpt_tpu.ops as jax_ops
import dcpt_tpu.ops.layernorm2d as jax_ln
import dcpt_tpu.ops.naf_ffn as jax_ffn
import dcpt_tpu.ops.naf_prefix as jax_prefix
from dcpt_tpu.archs import nafnet_arch as jax_nafnet
from dcpt_tpu_torch import ops
from dcpt_tpu_torch.archs import nafnet_arch
from dcpt_tpu_torch.convert.jax_params import params_to_state_dict
from dcpt_tpu_torch.ops import naf_ffn as tffn
from dcpt_tpu_torch.ops import naf_prefix as tprefix

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}  # relative to max(1, max|ref|)


def _inputs(op, b, h, w, c, seed):
    """x (B, H, W, C) and the op's parameters in dcpt_tpu's layouts, as numpy fp32."""
    rng = np.random.default_rng(seed)

    def r(*shape, scale=0.3, shift=0.0):
        return (rng.standard_normal(shape) * scale + shift).astype(np.float32)

    s = c ** -0.5
    if op == "prefix":
        params = [r(c, shift=1.0), r(c), r(c, 2 * c, scale=s), r(2 * c), r(3, 3, 2 * c, scale=1 / 3), r(2 * c)]
    else:
        params = [r(c, shift=1.0), r(c), r(c, 2 * c, scale=s), r(2 * c), r(c, c, scale=s), r(c), r(c)]
    return r(b, h, w, c, scale=1.0), params


def _jax_op(op, x, params):
    """dcpt_tpu's Pallas kernel in interpret mode on (B, H, W, C) arrays.  Its
    naf_ffn kernel stores an fp32 value into a bf16 output and so takes fp32
    only; in bf16 its jnp twin ``naf_ffn_ref`` (what its custom VJP
    differentiates) stands in for it."""
    if op == "prefix":
        return jax_prefix.naf_prefix(x, *params, 1e-6, True)
    if x.dtype == jnp.bfloat16:
        return jax_ffn.naf_ffn_ref(x.reshape(-1, x.shape[-1]), *params).reshape(x.shape)
    return jax_ffn.naf_ffn(x, *params, 1e-6, True)


def _torch_ref(op):
    return tprefix.naf_prefix_ref if op == "prefix" else tffn.naf_ffn_ref


# C = 64 and 512 at small maps, and a ragged 5 x 3 map (the dwconv's zero border on every side)
@pytest.mark.parametrize("shape", [(2, 4, 6, 64), (1, 4, 4, 512), (1, 5, 3, 64)])
@pytest.mark.parametrize("op", ["prefix", "ffn"])
def test_plain_versions_match_dcpt_tpu(op, shape):
    """fp32 within 1e-5 and bf16 within 2e-2 of max(1, max|ref|): the same rounded
    inputs through dcpt_tpu's kernel (interpret mode) and the port's plain version."""
    x, params = _inputs(op, *shape, seed=sum(shape))
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        tx, tp = torch.from_numpy(x).to(dtype), [torch.from_numpy(p).to(dtype) for p in params]
        got = _torch_ref(op)(tx, *tp).float().numpy()
        want = np.asarray(_jax_op(op, jnp.asarray(x, jdtype), [jnp.asarray(p, jdtype) for p in params]),
                          np.float32)
        assert got.shape == want.shape
        err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
        assert err <= TOL[dtype], (dtype, err)


@pytest.mark.parametrize("op", ["prefix", "ffn"])
def test_functions_gradients_match_plain_version(op):
    """The autograd Functions (K4 / K5 forward, the plain VJP backward) give the
    plain version's gradients for x and every parameter, and dcpt_tpu's custom
    VJP the same (its twin's VJP), within 1e-5 of max(1, max|ref|)."""
    x, params = _inputs(op, 2, 5, 3, 64, seed=7)
    dz = np.random.default_rng(8).standard_normal(x.shape[:3] + (64,)).astype(np.float32)
    leaves = [torch.from_numpy(t).requires_grad_() for t in (x, *params)]
    fn = tprefix.naf_prefix if op == "prefix" else tffn.naf_ffn
    fn(*leaves).backward(torch.from_numpy(dz))
    got = [t.grad.clone() for t in leaves]
    ref_leaves = [t.detach().clone().requires_grad_() for t in leaves]
    _torch_ref(op)(*ref_leaves).backward(torch.from_numpy(dz))
    _, vjp = jax.vjp(lambda *a: _jax_op(op, a[0], a[1:]), *(jnp.asarray(t) for t in (x, *params)))
    for g, r, j in zip(got, ref_leaves, vjp(jnp.asarray(dz))):
        assert torch.equal(g, r.grad)
        j = np.asarray(j)
        assert np.abs(g.numpy() - j).max() / max(1.0, np.abs(j).max()) <= 1e-5


CFG = dict(img_channel=3, width=32, middle_blk_num=1, enc_blk_nums=(1, 1, 1, 1), dec_blk_nums=(1, 1, 1, 1))


def _randomize(tree, rng, path=()):
    """beta, gamma and the LayerNorm affines drawn at random (at init every block is the identity)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize(v, rng, path + (k,))
        elif k in ("beta", "gamma") or (path and path[-1].startswith("norm")):
            shift = 1.0 if (path and path[-1].startswith("norm") and k == "weight") else 0.0
            out[k] = (rng.normal(0.0, 0.5, np.shape(v)) + shift).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


def test_nafnet_module_route_matches_dcpt_tpu(monkeypatch):
    """Width 32, one block a level: the middle block is c = 512.  The port with
    ``NAF_BLOCK_KERNEL`` off in the ``all`` mode (the module path, K4 and K5 at
    c = 512, their plain versions here) against dcpt_tpu under
    ``enable_pallas("all")`` with its ``_NAF_BLOCK_KERNEL`` off and its K4, K5
    and LayerNorm kernels in interpret mode: output and taps within 1e-4."""
    jnet = jax_nafnet.NAFNetBaseline(**CFG)
    init = jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))["params"]
    params = _randomize(jax.tree_util.tree_map(np.asarray, init), np.random.default_rng(0))
    tnet = nafnet_arch.NAFNetBaseline(**{k: list(v) if isinstance(v, tuple) else v for k, v in CFG.items()})
    tnet.load_state_dict(params_to_state_dict(params, "NAFNetBaseline"), strict=True)

    monkeypatch.setattr(jax_ops, "_PALLAS_MODE", "all")
    monkeypatch.setattr(jax_nafnet, "_NAF_BLOCK_KERNEL", False)
    calls = {"prefix": 0, "ffn": 0}

    def interpreted(name, fn, *args):
        calls[name] += 1
        return fn(*args, 1e-6, True)

    monkeypatch.setattr(jax_prefix, "naf_prefix", functools.partial(interpreted, "prefix", jax_prefix.naf_prefix))
    monkeypatch.setattr(jax_ffn, "naf_ffn", functools.partial(interpreted, "ffn", jax_ffn.naf_ffn))
    monkeypatch.setattr(jax_ops, "layer_norm_2d", lambda x, w, b, eps: jax_ln.layer_norm_2d(x, w, b, eps, True))
    monkeypatch.setattr(nafnet_arch, "NAF_BLOCK_KERNEL", False)
    monkeypatch.setattr(ops, "_KERNEL_MODE", "all")

    x = np.random.default_rng(1).random((1, 3, 32, 48), dtype=np.float32)
    jout, jtaps = jnet.apply({"params": params}, jnp.asarray(x.transpose(0, 2, 3, 1)))
    assert calls == {"prefix": 1, "ffn": 1}
    seen = []
    for name, module in (("K4", tprefix), ("K5", tffn)):
        monkeypatch.setattr(module, "_forward", functools.partial(lambda n, f, *a: seen.append(n) or f(*a), name,
                                                                  module._forward))
    with torch.inference_mode():
        out, taps = tnet(torch.from_numpy(x))
    assert seen == ["K4", "K5"]
    np.testing.assert_allclose(out.numpy(), np.asarray(jout).transpose(0, 3, 1, 2), atol=1e-4, rtol=0)
    for name, t in taps.items():
        np.testing.assert_allclose(t.numpy(), np.asarray(jtaps[name]).transpose(0, 3, 1, 2), atol=1e-4, rtol=0,
                                   err_msg=name)


def test_module_route_gradients_match_the_block_kernel_route(monkeypatch):
    """Under autograd the module route (K4 and K5 through their Functions at
    c = 512, the other stages as PyTorch modules) gives every parameter the
    gradient of the default route (every block through ``NAFBlockFunction``,
    K2's plain version), within 1e-4 of the tensor's max|g|."""
    torch.manual_seed(0)
    net = nafnet_arch.NAFNetBaseline(**{k: list(v) if isinstance(v, tuple) else v for k, v in CFG.items()})
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith(("beta", "gamma")) or ".norm" in name:
                p.normal_(1.0 if name.endswith("weight") else 0.0, 0.5)
    x = torch.rand(2, 3, 32, 16, generator=torch.Generator().manual_seed(2))

    def grads():
        net.zero_grad()
        out, _ = net(x)
        out.square().mean().backward()
        return {n: p.grad.clone() for n, p in net.named_parameters()}

    want = grads()
    monkeypatch.setattr(nafnet_arch, "NAF_BLOCK_KERNEL", False)
    monkeypatch.setattr(ops, "_KERNEL_MODE", "all")
    got = grads()
    for n, g in want.items():
        assert (got[n] - g).abs().max() <= 1e-4 * g.abs().max().clamp_min(1e-12), n
