"""JPEG decode and dcpt_tpu's ``.npz`` network snapshots in the PyTorch port,
against dcpt_tpu on the same bytes.

The shipped 5d train ymls read the OTS dehaze set as ``.jpg``: the port's
``imfrombytes`` sends every buffer that is not a PNG through ``cv2.imdecode``
with dcpt_tpu's flags and its uint8 -> float32 rounding, so the images are
bit-equal to dcpt_tpu's.  The fine-tune yml loads the stage-1 nets from
dcpt_tpu's ``.npz`` snapshots, which ``load_network`` reads through
``params_to_state_dict``.
"""

import sys

import cv2
import numpy as np
import pytest
import torch

import jax

import _torch_threads  # noqa: F401
from _torch_io_util import image
from dcpt_tpu.utils.img_util import imfrombytes as jax_imfrombytes
from dcpt_tpu.utils.tree_io import save_tree_npz
from dcpt_tpu_torch.convert.jax_params import params_to_state_dict
from dcpt_tpu_torch.models.base_model import BaseModel
from dcpt_tpu_torch.utils.img_util import imfrombytes


def _jpeg(shape, seed=0, quality=90):
    return cv2.imencode(".jpg", image(shape, seed), [cv2.IMWRITE_JPEG_QUALITY, quality])[1].tobytes()


@pytest.mark.parametrize("float32", [False, True])
@pytest.mark.parametrize("flag", ["color", "grayscale", "unchanged"])
def test_colour_jpeg_decodes_as_dcpt_tpu_does(flag, float32):
    """A cv2-encoded colour JPEG: the same dtype, shape and bits as dcpt_tpu's
    ``imfrombytes`` (the float32 case through its native reciprocal product)."""
    buf = _jpeg((37, 53, 3), seed=1)
    got, want = imfrombytes(buf, flag, float32=float32), jax_imfrombytes(buf, flag, float32=float32)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_gray_jpeg_unchanged_decodes_as_dcpt_tpu_does():
    """A gray JPEG read ``unchanged`` is (H, W): dcpt_tpu divides by 255 there, and so does the port."""
    buf = _jpeg((29, 31), seed=2)
    for float32 in (False, True):
        got, want = imfrombytes(buf, "unchanged", float32=float32), jax_imfrombytes(buf, "unchanged", float32=float32)
        assert got.shape == want.shape == (29, 31) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_without_cv2_a_jpeg_names_cv2_and_the_file_and_a_png_still_decodes(monkeypatch):
    """cv2 is imported at the first buffer that is not a PNG; when it does not
    import, the error names cv2 and the file, and PNGs keep the port's codec."""
    jpeg = _jpeg((8, 8, 3))
    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 raises ImportError
    with pytest.raises(ImportError) as info:
        imfrombytes(jpeg, path="hazy/0001_0.8_0.2.jpg")
    assert "cv2" in str(info.value) and "hazy/0001_0.8_0.2.jpg" in str(info.value)
    img = image((9, 7, 3), seed=4)
    png = cv2.imencode(".png", img)[1].tobytes()
    np.testing.assert_array_equal(imfrombytes(png, "color"), img)


NETS = {
    "NAFNetBaseline": {"type": "NAFNetBaseline", "width": 8, "enc_blk_nums": [1, 1], "middle_blk_num": 1,
                       "dec_blk_nums": [1, 1]},
    "PromptIR_NoImg_DC": {"type": "PromptIR_NoImg_DC", "feature_dims": [8, 16], "num_res_blocks": 1,
                          "num_classes": 5},
}


@pytest.mark.parametrize("arch", list(NETS))
def test_dcpt_tpu_npz_snapshot_loads(tmp_path, arch):
    """A dcpt_tpu ``.npz`` snapshot (its ``save_tree_npz`` of ``params`` and
    ``params_ema`` trees, made from a seeded port net by dcpt_tpu's own
    converter ``state_dict_to_params``) loads into the port's net with tensors
    equal to ``params_to_state_dict`` of the same trees, by each key; a missing
    ``params_ema`` falls back to ``params``."""
    from dcpt_tpu.archs import build_network as jax_build_network
    from dcpt_tpu.convert.torch_checkpoint import state_dict_to_params
    from dcpt_tpu_torch.archs import build_network

    torch.manual_seed(3)
    seed_net = build_network(NETS[arch])
    key_map = type(jax_build_network(NETS[arch])).torch_key_map
    params = state_dict_to_params({k: v.numpy().copy() for k, v in seed_net.state_dict().items()}, key_map=key_map)
    ema = jax.tree_util.tree_map(lambda a: np.asarray(a) * np.float32(0.5), params)
    both, only = str(tmp_path / "both.npz"), str(tmp_path / "params.npz")
    save_tree_npz(both, {"params": params, "params_ema": ema})
    save_tree_npz(only, {"params": params})
    loader = BaseModel({"num_gpu": 0})
    for path, key, tree in ((both, "params", params), (both, "params_ema", ema), (only, "params_ema", params)):
        net = build_network(NETS[arch])
        loader.load_network(net, path, strict=True, param_key=key)
        want = params_to_state_dict(jax.tree_util.tree_map(np.asarray, tree), arch)
        got = net.state_dict()
        assert set(got) == set(want)
        for name, value in want.items():
            assert torch.equal(got[name], value), f"{path} {key} {name}"
    round_trip = params_to_state_dict(jax.tree_util.tree_map(np.asarray, params), arch)
    assert all(torch.equal(round_trip[name], value) for name, value in seed_net.state_dict().items())
