"""SwinIR in the PyTorch port against dcpt_tpu's flax net, and the plain versions of
kernels K8 and K10 against dcpt_tpu's Pallas kernels in interpret mode.

The same seeded weights go to both nets through ``params_to_state_dict``.
Tiny configs (img_size 16, embed 12, 2 heads, window 4, two RSTBs of two
blocks, so every RSTB has a shifted block): on the CPU dcpt_tpu runs its
module path and the port the plain version of K8.  Also the two repairs of
this slice: ``build_network`` drops keys an arch does not take, and
``SRModel.pre_test`` pads to the largest window size or ``val.pad_multiple``.
"""

import logging
import math
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _torch_threads  # noqa: F401
from dcpt_tpu.archs.swinir_arch import SwinIR as JaxSwinIR
from dcpt_tpu.archs.swinir_arch import torch_key_map
from dcpt_tpu.archs.swinir_arch import window_partition as jax_partition
from dcpt_tpu.archs.swinir_arch import window_reverse as jax_reverse
from dcpt_tpu.convert.torch_checkpoint import state_dict_to_params
from dcpt_tpu.models.sr_model import SRModel as JaxSRModel
from dcpt_tpu.ops import window_attention as jwa
from dcpt_tpu_torch.archs import build_network, swinir_arch
from dcpt_tpu_torch.archs.swinir_arch import SwinIR
from dcpt_tpu_torch.convert.jax_params import params_to_state_dict
from dcpt_tpu_torch.models.sr_model import SRModel
from dcpt_tpu_torch.ops import window_attention as wa

TINY = dict(img_size=16, embed_dim=12, depths=(2, 2), num_heads=(2, 2), window_size=4, mlp_ratio=2.0)
# config -> (constructor overrides, input H x W): the four heads, the 3conv bottleneck,
# the absolute position embedding (needs H x W = img_size), and a window that
# shrinks to the configured img_size 4 (ws 4, no shift) on a larger runtime map
CONFIGS = {
    "denoise": (dict(), (16, 24)),
    "pixelshuffle": (dict(upscale=2, upsampler="pixelshuffle", resi_connection="3conv"), (16, 24)),
    "pixelshuffledirect": (dict(upscale=3, upsampler="pixelshuffledirect"), (16, 24)),
    "nearest+conv": (dict(upscale=4, upsampler="nearest+conv", ape=True), (16, 16)),
    "small_img": (dict(img_size=4, window_size=8), (8, 12)),
}
_LN = ("norm1", "norm2", "norm", "patch_embed_norm")


def seeded_params(shapes, rng):
    """Flax params of the given shapes: dense and conv kernels of unit gain, random
    LayerNorm affines, biases and position embedding of std 0.1."""

    def draw(path, leaf):
        name, parent = path[-1].key, path[-2].key if len(path) > 1 else ""
        if name == "kernel":
            v = rng.standard_normal(leaf.shape) / math.sqrt(math.prod(leaf.shape[:-1]))
        elif parent in _LN:
            v = rng.normal(1.0 if name == "weight" else 0.0, 0.3, leaf.shape)
        else:
            v = rng.normal(0.0, 0.1, leaf.shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


_NETS = {}


def _nets(config):
    """(flax params, jitted apply, the port's net with the same weights), built once per config."""
    if config not in _NETS:
        cfg = dict(TINY, **CONFIGS[config][0])
        jnet = JaxSwinIR(**cfg)
        h, w = CONFIGS[config][1]
        shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), jnp.zeros((1, h, w, 3)))["params"]
        params = seeded_params(shapes, np.random.default_rng(len(_NETS)))
        net = SwinIR(**cfg)
        net.load_state_dict(params_to_state_dict(params, "SwinIR"), strict=True)
        _NETS[config] = (params, jax.jit(jnet.apply, static_argnames="skip_tail"), net.eval())
    return _NETS[config]


def _rel_close(ours: torch.Tensor, ref, name: str, tol: float = 1e-4) -> None:
    """Within tol of max(1, max|ref|), the NHWC reference transposed to NCHW."""
    ref = np.asarray(ref).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=tol * max(1.0, np.abs(ref).max()), err_msg=name)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_forward_and_taps_match_jax(config):
    params, apply, net = _nets(config)
    h, w = CONFIGS[config][1]
    x = np.random.default_rng(1).random((1, 3, h, w), dtype=np.float32)
    jout, jtaps = apply({"params": params}, jnp.asarray(x.transpose(0, 2, 3, 1)))
    with torch.inference_mode():
        out, taps = net(torch.from_numpy(x))
    scale = net.upscale
    assert out.shape == (1, 3, h * scale, w * scale)
    _rel_close(out, jout, "out")
    assert list(taps) == ["encode_layers.0", "decode_layers0.residual_group"] and set(taps) == set(jtaps)
    for name, t in taps.items():
        _rel_close(t, jtaps[name], name)
    if scale == 1:
        assert np.abs(out.numpy() - x).max() > 0.1


def test_skip_tail_matches_jax():
    params, apply, net = _nets("denoise")
    x = np.random.default_rng(2).random((1, 3, 16, 24), dtype=np.float32)
    jout, jtaps = apply({"params": params}, jnp.asarray(x.transpose(0, 2, 3, 1)), skip_tail=True)
    with torch.inference_mode():
        out, taps = net(torch.from_numpy(x), skip_tail=True)
    assert out is None and jout is None and set(taps) == set(jtaps)
    for name, t in taps.items():
        _rel_close(t, jtaps[name], name)


def test_routes_agree(monkeypatch):
    """On the CPU the K8 route (its plain version), the K10 route
    (``DCPT_TPU_SWIN_BLOCK=0``) and the plain modules (a config outside the
    kernels' gate, here by qk_scale = hd^-0.5, the same number) give one output."""
    _, _, net = _nets("denoise")
    x = torch.from_numpy(np.random.default_rng(3).random((1, 3, 16, 24), dtype=np.float32))
    with torch.inference_mode():
        k8, _ = net(x)
        monkeypatch.setattr(swinir_arch, "SWIN_BLOCK_KERNEL", False)
        k10, _ = net(x)
        blocks = [m for m in net.modules() if isinstance(m, swinir_arch.SwinTransformerBlock)]
        for blk in blocks:
            monkeypatch.setattr(blk.attn, "qk_scale", (12 // 2) ** -0.5)
        assert not any(swinir_arch.swin_fused_gate(True, b.attn.qk_scale, 12, 2, 4, torch.float32) for b in blocks)
        plain, _ = net(x)
    torch.testing.assert_close(k10, k8, atol=1e-5, rtol=0)
    torch.testing.assert_close(plain, k8, atol=1e-5, rtol=0)


def _block_params(c, hidden, rng):
    """The 12 block parameters in the op's (in, out) layout, as numpy."""
    def r(*shape, scale=0.3, shift=0.0):
        return (rng.standard_normal(shape) * scale + shift).astype(np.float32)

    return [r(c, shift=1.0), r(c), r(c, 3 * c, scale=c ** -0.5), r(3 * c), r(c, c, scale=c ** -0.5), r(c),
            r(c, shift=1.0), r(c), r(c, hidden, scale=c ** -0.5), r(hidden), r(hidden, c, scale=hidden ** -0.5), r(c)]


def _jax_on_windows(x, ws, shift, fn):
    """dcpt_tpu's composition around its kernels: roll -> partition -> fn -> reverse -> roll."""
    _, h, w, _ = x.shape
    if shift:
        x = jnp.roll(x, (-shift, -shift), axis=(1, 2))
    out = jax_reverse(fn(jax_partition(x, ws)), ws, h, w)
    return jnp.roll(out, (shift, shift), axis=(1, 2)) if shift else out


# limit 1e-4 relative to max(1, max|ref|): fp32 sums in another order, and the
# Pallas kernel's Abramowitz-Stegun erf, about 1e-7 from erff
def test_k8_plain_version_matches_pallas_interpret():
    """An 8 x 8 map, ws 4, at shift 0 and 2: at shift 2 every window but one
    straddles the seam, and token (0, 0) of window (1, 1) is pixel (6, 6),
    whose shifted window holds pixels of rows 0-1 and columns 0-1 too."""
    for shift in (0, 2):
        rng = np.random.default_rng(10 + shift)
        x = rng.standard_normal((1, 8, 8, 12)).astype(np.float32)
        params = _block_params(12, 24, rng)
        ref = _jax_on_windows(jnp.asarray(x), 4, shift, lambda t: jwa.fused_swin_block(
            t, *map(jnp.asarray, params), 2, 1e-5, True))
        ours = wa.fused_swin_block(torch.from_numpy(x), *map(torch.from_numpy, params), 2, 4, shift)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=1e-4 * max(1.0, np.abs(ref).max()),
                                   err_msg=f"shift {shift}")
        # and the window-level twins on the same windows
        xw = jax_partition(jnp.asarray(x), 4)
        np.testing.assert_allclose(
            wa.swin_block_ref(torch.from_numpy(np.array(xw)), *map(torch.from_numpy, params), 2).numpy(),
            np.asarray(jwa.swin_block_ref(xw, *map(jnp.asarray, params), 2)), rtol=0,
            atol=1e-5 * max(1.0, np.abs(ref).max()), err_msg=f"shift {shift}")


def test_k10_plain_version_matches_pallas_interpret():
    """Without and with LN1, at shift 0 and 2, on two 8 x 12 maps."""
    for with_ln in (False, True):
        for shift in (0, 2):
            rng = np.random.default_rng(20 + shift + 2 * with_ln)
            x = rng.standard_normal((2, 8, 12, 12)).astype(np.float32)
            lnw, lnb, wqkv, bqkv, wproj, bproj = _block_params(12, 24, rng)[:6]
            attn = [wqkv, bqkv, wproj, bproj]
            if with_ln:
                ref = _jax_on_windows(jnp.asarray(x), 4, shift, lambda t: jwa.fused_window_attention_ln(
                    t, jnp.asarray(lnw), jnp.asarray(lnb), *map(jnp.asarray, attn), 2, 1e-5, True))
                ours = wa.fused_window_attention_ln(torch.from_numpy(x), torch.from_numpy(lnw),
                                                    torch.from_numpy(lnb), *map(torch.from_numpy, attn), 2, 4, shift)
            else:
                ref = _jax_on_windows(jnp.asarray(x), 4, shift, lambda t: jwa.fused_window_attention(
                    t, *map(jnp.asarray, attn), 2, True))
                ours = wa.fused_window_attention(torch.from_numpy(x), *map(torch.from_numpy, attn), 2, 4, shift)
            np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                                       atol=1e-4 * max(1.0, np.abs(ref).max()), err_msg=f"LN {with_ln} shift {shift}")


def test_reference_named_state_dict_loads_strictly():
    """The port's state dict carries the reference's names: it maps back onto
    dcpt_tpu's param tree through dcpt_tpu's own ``torch_key_map``, and a
    reference-named dict of the shipped layout (six RSTBs) loads with strict=True."""
    params, _, net = _nets("pixelshuffle")
    state = {k: v.numpy() for k, v in net.state_dict().items()}
    back = state_dict_to_params(state, torch_key_map)
    flat = jax.tree_util.tree_leaves_with_path(params)
    assert len(flat) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in flat:
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, leaf, err_msg=jax.tree_util.keystr(path))

    shipped = SwinIR(img_size=16, embed_dim=12, depths=[1] * 6, num_heads=[2] * 6, window_size=4, upscale=2,
                     upsampler="pixelshuffle")
    names = set(shipped.state_dict())
    assert {"encode_layers.0.residual_group.blocks.0.attn.qkv.weight", "decode_layers2.conv.weight",
            "patch_embed.norm.weight", "upsample.0.weight", "conv_before_upsample.0.weight"} <= names
    assert "mean" not in names
    SwinIR(img_size=16, embed_dim=12, depths=[1] * 6, num_heads=[2] * 6, window_size=4, upscale=2,
           upsampler="pixelshuffle").load_state_dict(shipped.state_dict(), strict=True)


def test_build_network_drops_unknown_keys_with_a_warning():
    """train_SwinIR_dcpt_5d.yml's network_g carries ``h: 128``, which dcpt_tpu ignores."""
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logger = logging.getLogger("dcpt_tpu_torch")
    logger.addHandler(handler)
    try:
        net = build_network({"type": "SwinIR", "name": "g", "h": 128, **dict(TINY, depths=[2, 2], num_heads=[2, 2])})
        restormer = build_network({"type": "Restormer_origin", "dim": 8, "num_blocks": [1, 1, 1, 1],
                                   "num_refinement_blocks": 1, "heads": [1, 2, 2, 4], "drop_rate": 0.1})
    finally:
        logger.removeHandler(handler)
    assert isinstance(net, SwinIR) and restormer.per_block_taps
    messages = [r.getMessage() for r in records]
    assert any("SwinIR" in m and "['h']" in m for m in messages), messages
    assert any("Restormer_origin" in m and "['drop_rate']" in m for m in messages), messages
    assert not any("name" in m for m in messages)


# (window_size, val.pad_multiple, input H x W): a list window size under a larger
# bucket (pads 10 x 14 to 16 x 16); a tuple, which collapses to its largest, 4
# (pads 13 x 16 to 16 x 16); nothing to pad
PAD_CASES = [([2, 4], 8, (10, 14)), ((4, 2), None, (13, 16)), (4, 0, (16, 16))]


def test_pre_test_pads_as_dcpt_tpu():
    """SRModel.pre_test and post_test of the port and of dcpt_tpu on the same
    input: the same reflect pad, and through the same tiny SwinIR the same output."""
    params, apply, net = _nets("denoise")
    for window_size, pad_multiple, size in PAD_CASES:
        opt = {"network_g": {"type": "SwinIR", "window_size": window_size}, "val": {"pad_multiple": pad_multiple}}
        lq = np.random.default_rng(4).random((1, 3, *size), dtype=np.float32)
        ours = types.SimpleNamespace(opt=opt, lq=torch.from_numpy(lq), scale=1)
        ref = types.SimpleNamespace(opt=opt, lq=jnp.asarray(lq.transpose(0, 2, 3, 1)), scale=1)
        SRModel.pre_test(ours)
        JaxSRModel.pre_test(ref)
        assert (ours.mod_pad_h, ours.mod_pad_w) == (ref.mod_pad_h, ref.mod_pad_w), window_size
        np.testing.assert_array_equal(ours.lq.numpy(), np.asarray(ref.lq).transpose(0, 3, 1, 2))
        with torch.inference_mode():
            ours.output = net(ours.lq)[0]
        ref.output = apply({"params": params}, ref.lq)[0]
        SRModel.post_test(ours)
        JaxSRModel.post_test(ref)
        assert ours.output.shape[-2:] == size
        _rel_close(ours.output, ref.output, f"output, window_size {window_size}")
