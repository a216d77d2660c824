"""Image I/O and numpy <-> tensor conversion (dcpt_tpu/utils/img_util.py).

Host images are HWC numpy BGR, as OpenCV would give them; tensors are CHW
(or NCHW) RGB float in [0, 1], as in the reference.  PNGs decode through
the port's own codec; any other buffer (the OTS dehaze set's JPEGs) through
``cv2.imdecode`` with dcpt_tpu's flags, cv2 imported at the first such buffer.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from . import png


_CV2_FLAGS = {"color": "IMREAD_COLOR", "grayscale": "IMREAD_GRAYSCALE", "unchanged": "IMREAD_UNCHANGED"}


def _cv2_decode(content: bytes, flag: str, path: str | None) -> np.ndarray:
    """A non-PNG buffer through ``cv2.imdecode`` as dcpt_tpu decodes it
    (its img_util.py:20-40); grayscale gains a channel axis."""
    if flag not in _CV2_FLAGS:
        raise ValueError(f"imfrombytes: unknown flag {flag!r}")
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"imfrombytes: {path or 'the buffer'} is not a PNG, and decoding it needs cv2 "
                          f"(OpenCV), which does not import: {e}") from e
    img = cv2.imdecode(np.frombuffer(content, np.uint8), getattr(cv2, _CV2_FLAGS[flag]))
    if img is None:
        raise ValueError(f"imfrombytes: cv2 cannot decode {path or 'the buffer'}")
    return img[..., None] if flag == "grayscale" else img


def imfrombytes(content: bytes, flag: str = "color", float32: bool = False, path: str | None = None) -> np.ndarray:
    """Decode an 8-bit image byte buffer the way ``cv2.imdecode`` does.

    ``flag``: ``color`` (3-channel BGR; gray is replicated, alpha dropped),
    ``grayscale`` (with a channel axis; a colour PNG raises) or ``unchanged``.
    ``path`` only names the file in an error.
    """
    if content[:8] != png.SIGNATURE:
        img = _cv2_decode(content, flag, path)
        if float32:
            # dcpt_tpu's rounding: the reciprocal product on HWC uint8, a division otherwise
            if img.dtype == np.uint8 and img.ndim == 3:
                return img.astype(np.float32) * np.float32(1 / 255)
            return img.astype(np.float32) / 255.0
        return img
    img = png.decode(content)
    if flag == "color":
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=2)
        elif img.shape[2] == 4:
            img = np.ascontiguousarray(img[..., :3])
    elif flag == "grayscale":
        if img.ndim != 2:
            raise ValueError("imfrombytes: grayscale decoding of colour PNGs is not ported yet")
        img = img[..., None]
    elif flag != "unchanged":
        raise ValueError(f"imfrombytes: unknown flag {flag!r}")
    if float32:
        img = img.astype(np.float32) * np.float32(1 / 255)  # dcpt_tpu's rounding (reciprocal product)
    return img


def img2tensor(imgs, bgr2rgb: bool = True, float32: bool = True):
    """HWC BGR numpy image(s) -> CHW RGB tensor(s) (reference: img_util.py:11-37)."""

    def _totensor(img):
        if img.ndim == 2:
            img = img[..., None]
        if img.shape[2] == 3 and bgr2rgb:
            img = img[..., ::-1]
        t = torch.from_numpy(np.ascontiguousarray(img.transpose(2, 0, 1)))
        return t.float() if float32 else t

    if isinstance(imgs, list):
        return [_totensor(img) for img in imgs]
    return _totensor(imgs)


def tensor2img(tensor, rgb2bgr: bool = True, out_type=np.uint8, min_max: tuple = (0, 1)):
    """(1, C, H, W) / (C, H, W) / (H, W) tensor(s) -> HWC BGR numpy image(s).

    Clamps to ``min_max``, rescales to [0, 1] and rounds at the target bit depth
    (reference: img_util.py:40-106).
    """

    def _toimg(t):
        img = t.detach().float().cpu().clamp_(*min_max)
        img = (img - min_max[0]) / (min_max[1] - min_max[0])
        if img.dim() == 4:
            if img.shape[0] != 1:
                raise ValueError(f"Only singleton batches convert to one image, got {tuple(img.shape)}")
            img = img[0]
        img = img.numpy()
        if img.ndim == 3:
            img = img.transpose(1, 2, 0)
            if img.shape[2] == 3 and rgb2bgr:
                img = img[..., ::-1]
            elif img.shape[2] == 1:
                img = img[..., 0]
        if out_type == np.uint8:
            img = (img * 255.0).round()
        elif out_type == np.uint16:
            img = (img * 65535.0).round()
        return np.ascontiguousarray(img).astype(out_type)

    if isinstance(tensor, (list, tuple)):
        return [_toimg(t) for t in tensor]
    return _toimg(tensor)


def imwrite(img: np.ndarray, file_path: str, auto_mkdir: bool = True) -> None:
    """Write a uint8 gray / BGR / BGRA image as PNG (the only format written here)."""
    if not file_path.lower().endswith(".png"):
        raise ValueError(f"imwrite: only .png is written by dcpt_tpu_torch, got {file_path}")
    if auto_mkdir:
        os.makedirs(os.path.abspath(os.path.dirname(file_path)), exist_ok=True)
    with open(file_path, "wb") as f:
        f.write(png.encode(img))
