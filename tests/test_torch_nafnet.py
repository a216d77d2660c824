"""NAFNetBaseline in the PyTorch port against dcpt_tpu's flax NAFNetBaseline,
with the same weights carried across by ``params_to_state_dict``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _torch_threads  # noqa: F401
from dcpt_tpu.archs.arch_util import LayerNorm2d as JaxLayerNorm2d
from dcpt_tpu.archs.nafnet_arch import NAFNetBaseline as JaxNAFNet
from dcpt_tpu.archs.nafnet_arch import torch_key_map
from dcpt_tpu.convert.torch_checkpoint import load_network_params, state_dict_to_params
from dcpt_tpu_torch.archs.arch_util import LayerNorm2d
from dcpt_tpu_torch.archs.nafnet_arch import NAFNetBaseline
from dcpt_tpu_torch.convert.jax_params import params_to_state_dict
from dcpt_tpu_torch.models.base_model import BaseModel

CFG = dict(img_channel=3, width=8, middle_blk_num=1, enc_blk_nums=(1, 1), dec_blk_nums=(1, 1))


def _randomize(tree, rng, path=()):
    """beta, gamma and the LayerNorm affines drawn from N(0, 0.5^2) (1 + that for
    norm weights): with their init values every block is the identity."""
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


@pytest.fixture(scope="module")
def nets():
    jnet = JaxNAFNet(**CFG)
    init = jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))["params"]
    params = _randomize(jax.tree_util.tree_map(np.asarray, init), np.random.default_rng(0))
    tnet = NAFNetBaseline(**{k: list(v) if isinstance(v, tuple) else v for k, v in CFG.items()})
    tnet.load_state_dict(params_to_state_dict(params, "NAFNetBaseline"), strict=True)
    return jnet, params, tnet.eval()


def test_forward_and_taps_match_jax(nets):
    jnet, params, tnet = nets
    x = np.random.default_rng(1).random((2, 3, 32, 32), dtype=np.float32)
    jout, jtaps = jnet.apply({"params": params}, jnp.asarray(x.transpose(0, 2, 3, 1)))
    with torch.inference_mode():
        out, taps = tnet(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout).transpose(0, 3, 1, 2), atol=1e-4, rtol=0)
    assert set(taps) == set(jtaps)
    for name, t in taps.items():
        np.testing.assert_allclose(t.numpy(), np.asarray(jtaps[name]).transpose(0, 3, 1, 2), atol=1e-4, rtol=0,
                                   err_msg=name)


def test_layer_norm_2d_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 6, 5, 7)).astype(np.float32) * 3 + 1
    w, b = rng.standard_normal(6).astype(np.float32), rng.standard_normal(6).astype(np.float32)
    ln = LayerNorm2d(6)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(w))
        ln.bias.copy_(torch.from_numpy(b))
        ours = ln(torch.from_numpy(x)).numpy()
    ref = JaxLayerNorm2d(6).apply({"params": {"weight": w, "bias": b}}, jnp.asarray(x.transpose(0, 2, 3, 1)))
    np.testing.assert_allclose(ours, np.asarray(ref).transpose(0, 3, 1, 2), atol=1e-5, rtol=0)


def test_skip_tail_returns_taps_only(nets):
    _, _, tnet = nets
    x = torch.from_numpy(np.random.default_rng(2).random((1, 3, 16, 16), dtype=np.float32))
    with torch.inference_mode():
        out, taps = tnet(x, skip_tail=True)
        _, full_taps = tnet(x)
    assert out is None
    assert list(taps) == list(full_taps)
    assert list(taps)[0] == "encoders.0"  # forward order


def test_params_round_trip_through_state_dict_to_params(nets):
    _, params, _ = nets
    state = {k: v.numpy() for k, v in params_to_state_dict(params, "NAFNetBaseline").items()}
    back = state_dict_to_params(state, key_map=torch_key_map)
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)


@pytest.mark.parametrize("key", ["params_ema", "params"])
def test_torch_checkpoint_loads_strictly_in_both_packages(nets, tmp_path, key):
    """A torch-saved ``{key: state_dict}``: the port loads it strictly under
    param_key params_ema (falling back to params), and dcpt_tpu's converter
    reads the same weights back."""
    jnet, params, tnet = nets
    path = str(tmp_path / "net.pth")
    torch.save({key: tnet.state_dict()}, path)
    fresh = NAFNetBaseline(**{k: list(v) if isinstance(v, tuple) else v for k, v in CFG.items()})
    BaseModel({"num_gpu": 0}).load_network(fresh, path, strict=True, param_key="params_ema")
    for (name, a), b in zip(tnet.state_dict().items(), fresh.state_dict().values()):
        assert torch.equal(a, b), name
    jparams = load_network_params(jnet, path, param_key="params_ema")["params"]
    for path_, leaf in jax.tree_util.tree_leaves_with_path(params):
        np.testing.assert_array_equal(dict(jax.tree_util.tree_leaves_with_path(jparams))[path_], leaf)


def test_strict_load_rejects_a_mismatched_checkpoint(nets, tmp_path):
    _, _, tnet = nets
    state = tnet.state_dict()
    state.pop("ending.bias")
    path = str(tmp_path / "bad.pth")
    torch.save({"params_ema": state}, path)
    with pytest.raises(RuntimeError, match="ending.bias"):
        BaseModel({"num_gpu": 0}).load_network(tnet, path, strict=True, param_key="params_ema")
