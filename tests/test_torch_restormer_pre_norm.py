"""The port's ``MDTA(x, pre_norm)`` and ``GDFN(x, pre_norm)`` against dcpt_tpu's,
and the TransformerBlock composed from the standalone ops, on the CPU.

With ``pre_norm = (ln_w, ln_b, eps, biasfree)`` x is the raw block input and the
LayerNorm and the qkv (project_in) 1x1 run as one ``fused_ln_proj`` call (K14's
plain version here).  Each module is held, on converted weights, to dcpt_tpu's
module called with the same ``pre_norm`` (its ``fused_ln_proj`` Pallas kernel
in interpret mode, as ``tests/test_ops.py`` runs it) and to the port's own
``norm -> module`` in both LayerNorm flavours.  Then ``chip_smoke.py``'s block
harness (``x + MDTA'(x, pre_norm=norm1)``, then ``+ GDFN(., pre_norm=norm2)``,
MDTA's attention through ``mdta_attention``) is held to the block's default
route (K6's plain version) in the Restormer and PromptIR flavours, forward and
gradients.  Tolerance: 1e-5 relative to max(1, max|ref|) (fp32 sums in
another order); gradients 1e-4.
"""

from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
import dcpt_tpu.ops.ln_proj as jax_lp
from dcpt_tpu.archs.restormer_arch import GDFN as JaxGDFN
from dcpt_tpu.archs.restormer_arch import MDTA as JaxMDTA
from dcpt_tpu.archs.restormer_arch import ChannelLayerNorm as JaxChannelLayerNorm
from dcpt_tpu_torch.archs.promptir_arch import PromptTransformerBlock
from dcpt_tpu_torch.archs.restormer_arch import GDFN, MDTA, ChannelLayerNorm, TransformerBlock
from dcpt_tpu_torch.convert.jax_params import params_to_state_dict
from dcpt_tpu_torch.ops import ln_proj, mdta

C = 32


def _close(ours: torch.Tensor, ref, tol: float, name: str) -> None:
    ref = np.asarray(ref)
    np.testing.assert_allclose(ours.detach().numpy(), ref, rtol=0, atol=tol * max(1.0, np.abs(ref).max()),
                               err_msg=name)


def _module_pair(kind: str, biasfree: bool):
    """dcpt_tpu's module, its seeded params, the port's module on the same
    weights, the LayerNorm's (weight, bias) and an NHWC input."""
    rng = np.random.default_rng(20 + biasfree + 2 * (kind == "gdfn"))
    x = (rng.random((1, 8, 8, C)) * 2 - 0.5).astype(np.float32)
    jmod = JaxMDTA(C, 2) if kind == "mdta" else JaxGDFN(C)
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(rng.standard_normal(a.shape).astype(np.float32) * 0.3),
                                    jmod.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"])
    if kind == "mdta":
        params["temperature"] = jnp.asarray(rng.random((2, 1, 1)).astype(np.float32) + 0.5)
    module = MDTA(C, 2) if kind == "mdta" else GDFN(C)
    state = params_to_state_dict({"m": params}, "Restormer_origin")
    module.load_state_dict({k.split(".", 1)[1]: v for k, v in state.items()}, strict=True)
    ln_w = (1 + 0.2 * rng.standard_normal(C)).astype(np.float32)
    ln_b = np.zeros(C, np.float32) if biasfree else (0.2 * rng.standard_normal(C)).astype(np.float32)
    return jmod, params, module, ln_w, ln_b, x


@pytest.mark.parametrize("kind", ["mdta", "gdfn"])
@pytest.mark.parametrize("biasfree", [True, False])
def test_pre_norm_matches_dcpt_tpu_and_norm_then_module(kind, biasfree, monkeypatch):
    """The module with pre_norm on the raw input: against dcpt_tpu's with the same
    pre_norm (its K14 in interpret mode), and against the port's ChannelLayerNorm
    followed by the module; K14's plain version ran once."""
    jmod, params, module, ln_w, ln_b, x = _module_pair(kind, biasfree)
    orig = jax_lp._lp_pallas
    monkeypatch.setattr(jax_lp, "_lp_pallas", lambda *a: orig(*a[:-1], True))
    pre = (jnp.asarray(ln_w), jnp.asarray(ln_b), 1e-6, biasfree)
    ref = jmod.apply({"params": params}, jnp.asarray(x), pre_norm=pre)
    norm = ChannelLayerNorm(C, not biasfree)
    norm.body.weight.data = torch.from_numpy(ln_w)
    if not biasfree:
        norm.body.bias.data = torch.from_numpy(ln_b)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    calls = []
    with torch.no_grad(), mock.patch.object(ln_proj, "ln_proj_ref", wraps=ln_proj.ln_proj_ref) as spy:
        fused = module(xt, pre_norm=(*norm.affine(), norm.eps, biasfree))
        calls.append(spy.call_count)
        plain = module(norm(xt))
    assert calls == [1]
    _close(fused, np.asarray(ref).transpose(0, 3, 1, 2), 1e-5, "against dcpt_tpu")
    _close(fused, plain.numpy(), 1e-5, "against norm -> module")
    jnorm = JaxChannelLayerNorm(C, bias=not biasfree)
    nparams = {"weight": jnp.asarray(ln_w)} if biasfree else {"weight": jnp.asarray(ln_w), "bias": jnp.asarray(ln_b)}
    base = jmod.apply({"params": params}, jnorm.apply({"params": nparams}, jnp.asarray(x)))
    _close(plain, np.asarray(base).transpose(0, 3, 1, 2), 1e-5, "norm -> module against dcpt_tpu's")


@pytest.mark.parametrize("block_cls", [TransformerBlock, PromptTransformerBlock])
def test_standalone_block_harness_matches_default_route(block_cls):
    """chip_smoke.py's harness (K14 at qkv and project_in, K13 for the attention)
    against the block's default route (K6's plain version, K7's plain version
    under autograd): the output and the gradients of x and every parameter, in
    the Restormer (ReLU, BiasFree, 1e-6) and PromptIR (softmax, WithBias, 1e-5)
    flavours, two images of 6 x 5 with two heads."""
    torch.manual_seed(5)
    block = block_cls(16, 2, 2.66, False, block_cls is PromptTransformerBlock)
    with torch.no_grad():
        for name, p in block.named_parameters():
            p.copy_(torch.rand(p.shape) + 0.5 if "norm" in name or "temperature" in name else p * 3)
    x = torch.randn(2, 16, 6, 5)
    g = torch.randn(2, 16, 6, 5)
    results = []
    for forward in (None, chip_smoke._standalone_transformer_forward):
        xi = x.clone().requires_grad_()
        block.zero_grad()
        with mock.patch.object(mdta, "mdta_ref", wraps=mdta.mdta_ref) as spy:
            out = block(xi) if forward is None else forward(block, xi)
            assert spy.call_count == (forward is not None)
        out.backward(g)
        results.append([out, xi.grad] + [p.grad.clone() for p in block.parameters()])
    names = ["out", "dx"] + [f"d{n}" for n, _ in block.named_parameters()]
    for got, want, name in zip(results[1], results[0], names):
        _close(got, want.detach().numpy(), 1e-5 if name == "out" else 1e-4, name)
