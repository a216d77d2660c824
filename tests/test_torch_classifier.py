"""The degradation classifiers of the PyTorch port against dcpt_tpu's flax ones,
with the same weights carried across by ``params_to_state_dict``
(feature_dims [8, 16, 32, 64], NCHW features of the NAFNet 'ups' pyramid)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _torch_threads  # noqa: F401
from dcpt_tpu.archs import degrad_classify_arch as jdc
from dcpt_tpu_torch.archs import degrad_classify_arch as tdc
from dcpt_tpu_torch.convert.jax_params import params_to_state_dict
from test_torch_dcpt import _randomize

DIMS = [8, 16, 32, 64]


def _features(rng, b=2, hw=32):
    return [rng.standard_normal((b, d, hw >> i, hw >> i)).astype(np.float32) for i, d in enumerate(DIMS)]


@pytest.mark.parametrize("arch", ["PromptIR_NoImg_DC", "PromptIR_DC"])
def test_logits_match_jax(arch):
    """Logits within 1e-4 of dcpt_tpu's, with random norm affines and mixing weights."""
    rng = np.random.default_rng(1)
    feats = _features(rng)
    lq = rng.random((2, 3, 64, 64)).astype(np.float32)
    jnet = getattr(jdc, arch)(feature_dims=DIMS, num_res_blocks=2, num_classes=5)
    jfeats = [jnp.asarray(f.transpose(0, 2, 3, 1)) for f in feats]
    jlq = jnp.asarray(lq.transpose(0, 2, 3, 1))
    params = _randomize(jax.tree_util.tree_map(np.asarray, jnet.init(jax.random.PRNGKey(0), jlq, jfeats)["params"]),
                        rng)
    tnet = getattr(tdc, arch)(feature_dims=DIMS, num_res_blocks=2, num_classes=5)
    tnet.load_state_dict(params_to_state_dict(params, arch), strict=True)
    with torch.no_grad():
        ours = tnet(torch.from_numpy(lq), [torch.from_numpy(f) for f in feats]).numpy()
    ref = np.asarray(jnet.apply({"params": params}, jlq, jfeats))
    assert ours.shape == (2, 5)
    np.testing.assert_allclose(ours, ref, atol=1e-4, rtol=1e-4)


def test_reference_key_names_and_init():
    """The reference's state-dict keys, and the Caffe2 MSRA fill (fan_out) of the convs."""
    net = tdc.PromptIR_DC(feature_dims=DIMS, num_res_blocks=1, num_classes=3)
    keys = set(net.state_dict())
    for key in ("bottleneck_layers.0.0.conv1.weight", "bottleneck_layers.0.0.conv1.norm.weight",
                "downsample_layers.2.0.weight", "last_stage.0.conv3.norm.bias", "conv_embed.0.weight",
                "conv_embed.1.bias", "fc.weight", "mixing_weights"):
        assert key in keys, key
    w = tdc.PromptIR_NoImg_DC(feature_dims=[64, 128, 256, 512]).bottleneck_layers[3][0].conv1.weight
    fan_out = w.shape[0] * w.shape[2] * w.shape[3]
    assert abs(w.std().item() - (2 / fan_out) ** 0.5) < 0.1 * (2 / fan_out) ** 0.5


def test_token_features_downsample_as_jax():
    """``downsample``: (B, N, C) tokens become maps and level i shrinks by 1/2^i
    (nearest), as dcpt_tpu's jax.image.resize does."""
    rng = np.random.default_rng(2)
    toks = [rng.standard_normal((2, 32 * 32, d)).astype(np.float32) for d in DIMS]
    jnet = jdc.PromptIR_NoImg_DC(feature_dims=DIMS, num_res_blocks=1, num_classes=4, downsample=True)
    jtoks = [jnp.asarray(t) for t in toks]
    params = _randomize(jax.tree_util.tree_map(
        np.asarray, jnet.init(jax.random.PRNGKey(0), jnp.zeros((2, 32, 32, 3)), jtoks)["params"]), rng)
    tnet = tdc.PromptIR_NoImg_DC(feature_dims=DIMS, num_res_blocks=1, num_classes=4, downsample=True)
    tnet.load_state_dict(params_to_state_dict(params, "PromptIR_NoImg_DC"), strict=True)
    with torch.no_grad():
        ours = tnet(None, [torch.from_numpy(t) for t in toks]).numpy()
    ref = np.asarray(jnet.apply({"params": params}, jnp.zeros((2, 32, 32, 3)), jtoks))
    np.testing.assert_allclose(ours, ref, atol=1e-4, rtol=1e-4)
