"""Helpers of the port's file-format tests (``test_torch_io_*.py``): test images,
a PNG encoder with one row filter on every row, and the shipped option files."""

import glob
import os
import struct
import zlib

import cv2
import numpy as np

from dcpt_tpu_torch.utils import png

OPTIONS = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "..", "options", "**", "*.yml"), recursive=True))
KINDS = {"gray": (23, 37), "bgr": (23, 37, 3), "bgra": (19, 26, 4)}


def image(shape, seed=0):
    """A gradient plus noise, so the PNG filters have something to predict."""
    rng = np.random.default_rng(seed)
    ramp = np.linspace(0, 180, shape[1]).reshape((1, shape[1]) + (1,) * (len(shape) - 2))
    return (rng.random(shape) * 70 + ramp).astype(np.uint8)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def png_with_filter(img, ftype):
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


def cv2_decode(buf, flag=cv2.IMREAD_UNCHANGED):
    return cv2.imdecode(np.frombuffer(buf, np.uint8), flag)
