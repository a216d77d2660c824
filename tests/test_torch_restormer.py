"""Restormer, Restormer_origin and PromptIR in the PyTorch port against dcpt_tpu's
flax nets, with the same seeded weights carried across by ``params_to_state_dict``.

Tiny configs (Restormer dim 8, PromptIR dim 48 with its fixed 64/128/320-wide
prompts, one block per level); on the CPU every bias-free TransformerBlock of
the port runs K6's plain version, dcpt_tpu its module path.  Their parts
(blocks, norms, resizes, heads) are in tests/test_torch_restormer_modules.py.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dcpt_tpu.archs.promptir_arch import PromptIR as JaxPromptIR
from dcpt_tpu.archs.restormer_arch import Restormer as JaxRestormer
from dcpt_tpu.archs.restormer_arch import Restormer_origin as JaxRestormerOrigin
from dcpt_tpu.convert.torch_checkpoint import state_dict_to_params
from dcpt_tpu_torch.archs.promptir_arch import PromptIR
from dcpt_tpu_torch.archs.restormer_arch import Restormer, Restormer_origin
from dcpt_tpu_torch.convert.jax_params import params_to_state_dict

TINY = dict(dim=8, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1, heads=(1, 2, 2, 4))
ARCHS = {
    "Restormer": (JaxRestormer, Restormer, TINY),
    "Restormer_origin": (JaxRestormerOrigin, Restormer_origin, TINY),
    # tests/test_pipeline_all_archs.py's PromptIR
    "PromptIR": (JaxPromptIR, PromptIR, dict(dim=48, num_blocks=(1, 1, 1, 1), num_refinement_blocks=1,
                                             heads=(1, 2, 4, 8))),
}
SIZES = [(32, 32), (40, 24)]  # 40 x 24: a 5 x 3 latent, so the prompts' bilinear resizes are not identities


def seeded_params(shapes, rng):
    """Flax params of the given shapes, drawn so that every branch shows: conv and
    dense kernels of unit gain (std 1/sqrt(fan-in)), random LayerNorm affines
    and temperatures, the prompt banks uniform in [0, 1) as the reference's init."""

    def draw(path, leaf):
        name = path[-1].key
        parent = path[-2].key if len(path) > 1 else ""
        shape = leaf.shape
        if name == "kernel":
            v = rng.standard_normal(shape) / math.sqrt(math.prod(shape[:-1]))
        elif parent.startswith("norm"):
            v = rng.normal(1.0 if name == "weight" else 0.0, 0.3, shape)
        elif name == "temperature":
            v = rng.uniform(0.5, 1.5, shape)
        elif name == "prompt_param":
            v = rng.random(shape)
        else:
            v = rng.normal(0.0, 0.1, shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


_NETS = {}


@pytest.fixture(params=list(ARCHS))
def nets(request):
    """(arch, flax net, its params, the port's net with the same weights), built once per arch."""
    arch = request.param
    if arch not in _NETS:
        jax_cls, cls, cfg = ARCHS[arch]
        jnet = jax_cls(**cfg)
        shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))["params"]
        params = seeded_params(shapes, np.random.default_rng(0))
        net = cls(**{k: list(v) if isinstance(v, tuple) else v for k, v in cfg.items()})
        net.load_state_dict(params_to_state_dict(params, arch), strict=True)
        _NETS[arch] = (arch, jnet, params, jax.jit(jnet.apply, static_argnames="skip_tail"), net.eval())
    return _NETS[arch]


def _rel_close(ours: torch.Tensor, ref, name: str) -> None:
    """Within 1e-4 of max(1, max|ref|), the NHWC reference transposed to NCHW."""
    ref = np.asarray(ref).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-4 * max(1.0, np.abs(ref).max()), err_msg=name)


@pytest.mark.parametrize("size", SIZES)
def test_forward_and_taps_match_jax(nets, size):
    _, _, params, apply, net = nets
    x = np.random.default_rng(1).random((1, 3, *size), dtype=np.float32)
    jout, jtaps = apply({"params": params}, jnp.asarray(x.transpose(0, 2, 3, 1)))
    with torch.inference_mode():
        out, taps = net(torch.from_numpy(x))
    _rel_close(out, jout, "out")
    assert set(taps) == set(jtaps)  # jit returns the dict sorted by key; the port's is in forward order
    for name, t in taps.items():
        _rel_close(t, jtaps[name], name)
    assert np.abs(out.numpy() - x).max() > 0.1


def test_skip_tail_matches_jax(nets):
    """The feature-only pass: out is None and the taps are dcpt_tpu's skip-tail taps
    (Restormer stops after decoder_level1, PromptIR after reduce_noise_level1)."""
    arch, _, params, apply, net = nets
    x = np.random.default_rng(2).random((1, 3, 32, 32), dtype=np.float32)
    jout, jtaps = apply({"params": params}, jnp.asarray(x.transpose(0, 2, 3, 1)), skip_tail=True)
    with torch.inference_mode():
        out, taps = net(torch.from_numpy(x), skip_tail=True)
    assert out is None and jout is None
    assert set(taps) == set(jtaps)
    last = {"Restormer": "decoder_level1.body", "Restormer_origin": "decoder_level1.0", "PromptIR": "decoder_level2.0"}
    assert list(taps)[-1] == last[arch]
    for name, t in taps.items():
        _rel_close(t, jtaps[name], name)


def test_state_dict_keys_map_onto_every_flax_leaf(nets):
    """dcpt_tpu's torch_key_map of every key of the port's state_dict lands on a
    flax leaf, each leaf once, and its converter reads the weights back unchanged."""
    arch, jnet, params, _, net = nets
    state = {k: v.numpy() for k, v in net.state_dict().items()}
    back = dict(jax.tree_util.tree_leaves_with_path(state_dict_to_params(state, key_map=type(jnet).torch_key_map)))
    want = jax.tree_util.tree_leaves_with_path(params)
    assert len(back) == len(state) == len(want), arch
    for path, leaf in want:
        np.testing.assert_array_equal(back[path], leaf, err_msg=jax.tree_util.keystr(path))
