"""The parts of the PyTorch port's Restormer, Restormer_origin and PromptIR
against dcpt_tpu's flax modules, with the same seeded weights: one
TransformerBlock on both of its paths, the channel LayerNorms, the bilinear
resize and pixel shuffles the prompts and samplers use, Restormer's SR and
dual-pixel heads, and Restormer_origin's per-block taps.  The whole nets are
in tests/test_torch_restormer.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from test_torch_restormer import TINY, _rel_close, seeded_params

from dcpt_tpu.archs.arch_util import pixel_shuffle as jax_pixel_shuffle
from dcpt_tpu.archs.arch_util import pixel_unshuffle as jax_pixel_unshuffle
from dcpt_tpu.archs.arch_util import resize_bilinear as jax_resize_bilinear
from dcpt_tpu.archs.promptir_arch import ChannelLayerNorm5 as JaxChannelLayerNorm5
from dcpt_tpu.archs.restormer_arch import ChannelLayerNorm as JaxChannelLayerNorm
from dcpt_tpu.archs.restormer_arch import Restormer as JaxRestormer
from dcpt_tpu.archs.restormer_arch import TransformerBlock as JaxTransformerBlock
from dcpt_tpu_torch.archs import arch_util
from dcpt_tpu_torch.archs.promptir_arch import ChannelLayerNorm5
from dcpt_tpu_torch.archs.restormer_arch import ChannelLayerNorm, Restormer, Restormer_origin, TransformerBlock
from dcpt_tpu_torch.convert.jax_params import params_to_state_dict


def test_restormer_origin_taps_each_block():
    net = Restormer_origin(dim=8, num_blocks=[2, 1, 1, 1], num_refinement_blocks=2, heads=[1, 2, 2, 4]).eval()
    with torch.inference_mode():
        _, taps = net(torch.rand(1, 3, 16, 16, generator=torch.Generator().manual_seed(0)))
    assert list(taps) == ["encoder_level1.0", "encoder_level1.1", "encoder_level2.0", "encoder_level3.0", "latent.0",
                          "decoder_level3.0", "decoder_level2.0", "decoder_level1.0", "decoder_level1.1",
                          "refinement.0", "refinement.1"]
    assert "encoder_level1.1.norm1.body.bias" in net.state_dict()  # WithBias by default


@pytest.mark.parametrize("bias", [False, True])
def test_transformer_block_module_paths_match_jax(bias):
    """One block: with bias-free convs the port runs K6's plain version, with
    ``bias`` the plain MDTA / GDFN modules, both against dcpt_tpu's module path
    (WithBias LN, softmax attention, two heads)."""
    jblock = JaxTransformerBlock(16, 2, 2.66, bias, True, True)
    x = np.random.default_rng(3).standard_normal((2, 6, 5, 16)).astype(np.float32)
    shapes = jax.eval_shape(jblock.init, jax.random.PRNGKey(0), jnp.zeros(x.shape))["params"]
    params = seeded_params(shapes, np.random.default_rng(4))
    block = TransformerBlock(16, 2, 2.66, bias, True, True)
    state = params_to_state_dict({"blk_0": params}, "Restormer_origin")
    block.load_state_dict({k.split(".", 1)[1]: v for k, v in state.items()}, strict=True)
    assert block.use_kernel is not bias
    with torch.inference_mode():
        out = block(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    ref = jblock.apply({"params": params}, jnp.asarray(x))
    _rel_close(out, ref, "block")


@pytest.mark.parametrize("norm,jax_norm,bias", [(ChannelLayerNorm, JaxChannelLayerNorm, False),
                                                (ChannelLayerNorm, JaxChannelLayerNorm, True),
                                                (ChannelLayerNorm5, JaxChannelLayerNorm5, True)])
def test_channel_layer_norms_match_jax(norm, jax_norm, bias):
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((2, 7, 5, 3)) * 3 + 1).astype(np.float32)
    p = {"weight": rng.standard_normal(7).astype(np.float32)}
    if bias:
        p["bias"] = rng.standard_normal(7).astype(np.float32)
    ln = norm(7, bias)
    ln.body.load_state_dict({k: torch.from_numpy(v) for k, v in p.items()}, strict=True)
    with torch.no_grad():
        ours = ln(torch.from_numpy(x))
    _rel_close(ours, jax_norm(7, bias).apply({"params": p}, jnp.asarray(x.transpose(0, 2, 3, 1))), "norm")


@pytest.mark.parametrize("out_hw", [(61, 41), (5, 3), (16, 16)])
def test_resize_bilinear_matches_jax(out_hw):
    """Up (the 488 x 328 eval image's latent from a 16 x 16 bank), down and identity."""
    x = np.random.default_rng(7).standard_normal((2, 4, 16, 16)).astype(np.float32)
    ours = arch_util.resize_bilinear(torch.from_numpy(x), out_hw)
    _rel_close(ours, jax_resize_bilinear(jnp.asarray(x.transpose(0, 2, 3, 1)), out_hw), "resize")


def test_pixel_shuffles_match_jax():
    """PyTorch's pixel (un)shuffle, which the port's Upsample / Downsample and SR
    heads use, in dcpt_tpu's channel order."""
    x = np.random.default_rng(8).standard_normal((1, 8, 6, 4)).astype(np.float32)
    xt, xj = torch.from_numpy(x), jnp.asarray(x.transpose(0, 2, 3, 1))
    np.testing.assert_array_equal(torch.nn.PixelShuffle(2)(xt).numpy(),
                                  np.asarray(jax_pixel_shuffle(xj, 2)).transpose(0, 3, 1, 2))
    np.testing.assert_array_equal(torch.nn.PixelUnshuffle(2)(xt).numpy(),
                                  np.asarray(jax_pixel_unshuffle(xj, 2)).transpose(0, 3, 1, 2))


@pytest.mark.parametrize("extra", [{"scale": 2}, {"dual_pixel_task": True, "inp_channels": 6}])
def test_restormer_heads_match_jax(extra):
    """The SR heads (2^scale output convs through a pixel shuffle, keys
    ``output.{i}``) and the dual-pixel head (``skip_conv``) against dcpt_tpu."""
    cfg = dict(TINY, **extra)
    jnet = JaxRestormer(**cfg)
    x = np.random.default_rng(9).random((1, cfg.get("inp_channels", 3), 16, 16), dtype=np.float32)
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, x.shape[1])))["params"]
    params = seeded_params(shapes, np.random.default_rng(10))
    net = Restormer(**{k: list(v) if isinstance(v, tuple) else v for k, v in cfg.items()})
    net.load_state_dict(params_to_state_dict(params, "Restormer"), strict=True)
    jout, _ = jax.jit(jnet.apply)({"params": params}, jnp.asarray(x.transpose(0, 2, 3, 1)))
    with torch.inference_mode():
        out, _ = net.eval()(torch.from_numpy(x))
    assert out.shape == (1, 3, 16 * cfg.get("scale", 1), 16 * cfg.get("scale", 1))
    _rel_close(out, jout, "out")
