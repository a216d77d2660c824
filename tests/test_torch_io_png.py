"""The PyTorch port's own file formats against the libraries dcpt_tpu reads them
with: its PNG codec against OpenCV."""

import cv2
import numpy as np
import pytest

import _torch_threads  # noqa: F401
from _torch_io_util import KINDS, cv2_decode, image
from dcpt_tpu_torch.utils import png
from dcpt_tpu_torch.utils.img_util import imfrombytes, img2tensor, imwrite, tensor2img


@pytest.mark.parametrize("kind", list(KINDS))
def test_png_decodes_what_cv2_writes(kind):
    img = image(KINDS[kind])
    buf = cv2.imencode(".png", img)[1].tobytes()
    np.testing.assert_array_equal(png.decode(buf), cv2_decode(buf))
    np.testing.assert_array_equal(imfrombytes(buf, "color"), cv2_decode(buf, cv2.IMREAD_COLOR))


@pytest.mark.parametrize("kind", list(KINDS))
def test_cv2_reads_what_png_writes(kind, tmp_path):
    img = image(KINDS[kind], seed=7)
    path = str(tmp_path / "sub" / "img.png")
    imwrite(img, path)
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), img)


def test_png_refuses_what_it_does_not_decode():
    img16 = (np.arange(64, dtype=np.uint16).reshape(8, 8) * 1000)
    with pytest.raises(ValueError, match="8-bit"):
        png.decode(cv2.imencode(".png", img16)[1].tobytes())
    jpeg = cv2.imencode(".jpg", image((8, 8, 3)))[1].tobytes()
    with pytest.raises(ValueError, match="not a PNG"):
        png.decode(jpeg)


def test_img2tensor_and_tensor2img_invert_each_other():
    img = image((9, 11, 3), seed=3)
    t = img2tensor(img.astype(np.float32) / 255.0)
    assert t.shape == (3, 9, 11)
    np.testing.assert_array_equal(t.numpy()[0] * 255.0, img[..., 2].astype(np.float32))  # RGB order
    np.testing.assert_array_equal(tensor2img(t[None]), img)
