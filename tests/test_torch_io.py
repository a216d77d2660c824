"""The PyTorch port's own file formats against the libraries dcpt_tpu reads them
with: its PNG codec against OpenCV, its YAML loader against PyYAML."""

import glob
import os
import struct
import zlib

import cv2
import numpy as np
import pytest
import yaml

from dcpt_tpu_torch.utils import png
from dcpt_tpu_torch.utils.img_util import imfrombytes, img2tensor, imwrite, tensor2img
from dcpt_tpu_torch.utils.yaml_lite import YamlError, loads

OPTIONS = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "..", "options", "**", "*.yml"), recursive=True))
KINDS = {"gray": (23, 37), "bgr": (23, 37, 3), "bgra": (19, 26, 4)}


def _image(shape, seed=0):
    """A gradient plus noise, so the PNG filters have something to predict."""
    rng = np.random.default_rng(seed)
    ramp = np.linspace(0, 180, shape[1]).reshape((1, shape[1]) + (1,) * (len(shape) - 2))
    return (rng.random(shape) * 70 + ramp).astype(np.uint8)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _png_with_filter(img, ftype):
    """Encode with one PNG row filter on every row (the spec's forward filters)."""
    ctype = {2: 0, 3: 2}[img.ndim] if img.ndim == 2 or img.shape[2] == 3 else 6
    pix = img[..., None] if img.ndim == 2 else (img[..., ::-1] if img.shape[2] == 3 else img[..., [2, 1, 0, 3]])
    h, w, bpp = pix.shape
    rows = pix.reshape(h, w * bpp).astype(np.int64)
    out = []
    for r in range(h):
        cur, prev = rows[r], rows[r - 1] if r else np.zeros(w * bpp, np.int64)
        filt = np.empty_like(cur)
        for i in range(w * bpp):
            a = cur[i - bpp] if i >= bpp else 0
            b = prev[i]
            c = prev[i - bpp] if i >= bpp else 0
            pred = [0, a, b, (a + b) // 2, _paeth(a, b, c)][ftype]
            filt[i] = (cur[i] - pred) % 256
        out.append(bytes([ftype]) + filt.astype(np.uint8).tobytes())
    ihdr = struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)
    return png.SIGNATURE + png._chunk(b"IHDR", ihdr) + png._chunk(b"IDAT", zlib.compress(b"".join(out))) + \
        png._chunk(b"IEND", b"")


def _cv2_decode(buf, flag=cv2.IMREAD_UNCHANGED):
    return cv2.imdecode(np.frombuffer(buf, np.uint8), flag)


@pytest.mark.parametrize("kind", list(KINDS))
def test_png_decodes_what_cv2_writes(kind):
    img = _image(KINDS[kind])
    buf = cv2.imencode(".png", img)[1].tobytes()
    np.testing.assert_array_equal(png.decode(buf), _cv2_decode(buf))
    np.testing.assert_array_equal(imfrombytes(buf, "color"), _cv2_decode(buf, cv2.IMREAD_COLOR))


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_png_decodes_every_row_filter(kind, ftype):
    img = _image(KINDS[kind], seed=ftype)
    buf = _png_with_filter(img, ftype)
    np.testing.assert_array_equal(_cv2_decode(buf), img)  # the test's encoder is right
    np.testing.assert_array_equal(png.decode(buf), img)


@pytest.mark.parametrize("kind", list(KINDS))
def test_cv2_reads_what_png_writes(kind, tmp_path):
    img = _image(KINDS[kind], seed=7)
    path = str(tmp_path / "sub" / "img.png")
    imwrite(img, path)
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), img)


def test_png_refuses_what_it_does_not_decode():
    img16 = (np.arange(64, dtype=np.uint16).reshape(8, 8) * 1000)
    with pytest.raises(ValueError, match="8-bit"):
        png.decode(cv2.imencode(".png", img16)[1].tobytes())
    jpeg = cv2.imencode(".jpg", _image((8, 8, 3)))[1].tobytes()
    with pytest.raises(ValueError, match="JPEG"):
        imfrombytes(jpeg)


def test_img2tensor_and_tensor2img_invert_each_other():
    img = _image((9, 11, 3), seed=3)
    t = img2tensor(img.astype(np.float32) / 255.0)
    assert t.shape == (3, 9, 11)
    np.testing.assert_array_equal(t.numpy()[0] * 255.0, img[..., 2].astype(np.float32))  # RGB order
    np.testing.assert_array_equal(tensor2img(t[None]), img)


@pytest.mark.parametrize("path", OPTIONS, ids=[os.path.basename(p) for p in OPTIONS])
def test_yaml_loader_equals_pyyaml_on_shipped_options(path):
    with open(path) as f:
        text = f.read()
    assert loads(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", [
    "a: [1, -2, 2.5, 1.0e-4, 1e-4, .5, ~, null, yes, Off, 010, 0x1F, 0b11, .inf, -.inf, 1_000]",
    "a: {b: {c: [d, 'e f', \"g\\th\"]}, f: {}, g: []}  # comment",
    "a: 'it''s #not a comment'\nb:\n  c: x#y\n  d:\n",
    "list: [[1, 2], {k: v}]\nnested:\n  deeper:\n    deepest: 3\n",
])
def test_yaml_loader_resolves_scalars_like_pyyaml(text):
    assert loads(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", ["a:\n  - 1\n  - 2\n", "a: &x 1\n", "a: |\n  text\n", "---\na: 1\n"])
def test_yaml_loader_raises_outside_its_subset(text):
    with pytest.raises(YamlError):
        loads(text)
