"""8-bit PNG encode / decode on zlib and numpy, so image I/O needs no OpenCV.

Decodes non-interlaced 8-bit gray, RGB and RGBA PNGs with any of the five row
filters (what ``cv2.imwrite`` writes) and returns them as OpenCV would: gray
(H, W), BGR (H, W, 3) or BGRA (H, W, 4) uint8.  Encodes the same three kinds
with filter 0.  Palette, 16-bit, gray+alpha and interlaced files raise.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}  # colour type -> samples per pixel


def _unfilter(raw: np.ndarray, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters; (h, w, bpp) uint8.

    A pixel depends on its left, upper and upper-left neighbours, so every
    anti-diagonal r + x = d is reconstructed at once from the two before it.
    """
    rows = raw.reshape(h, 1 + w * bpp)
    ftype = rows[:, 0]
    if ftype.max(initial=0) > 4:
        raise ValueError(f"PNG: bad filter type {int(ftype.max())}")
    filt = rows[:, 1:].reshape(h, w, bpp).astype(np.int32)
    if not ftype.any():
        return filt.astype(np.uint8)
    out = np.zeros((h + 1, w + 1, bpp), np.int32)  # row 0 / column 0: the zero border
    for d in range(h + w - 1):
        r = np.arange(max(0, d - w + 1), min(h - 1, d) + 1)
        x = d - r
        a = out[r + 1, x]  # left
        b = out[r, x + 1]  # up
        c = out[r, x]  # up-left
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        ft = ftype[r][:, None]
        pred = np.select([ft == 1, ft == 2, ft == 3, ft == 4], [a, b, (a + b) >> 1, paeth], 0)
        out[r + 1, x + 1] = (filt[r, x] + pred) & 255
    return out[1:, 1:].astype(np.uint8)


def decode(content: bytes) -> np.ndarray:
    """PNG bytes -> gray (H, W), BGR (H, W, 3) or BGRA (H, W, 4) uint8."""
    if content[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(content):
        length, kind = struct.unpack(">I4s", content[pos : pos + 8])
        data = content[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(f"PNG: only 8-bit gray/RGB/RGBA without interlace decode here (bit depth {depth}, "
                         f"colour type {ctype}, interlace {interlace})")
    bpp = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * bpp):
        raise ValueError("PNG: image data has the wrong size")
    img = _unfilter(raw, h, w, bpp)
    if bpp == 1:
        return img[..., 0]
    if bpp == 3:
        return np.ascontiguousarray(img[..., ::-1])
    return np.ascontiguousarray(img[..., [2, 1, 0, 3]])


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)


def encode(img: np.ndarray) -> bytes:
    """Gray (H, W) / (H, W, 1), BGR (H, W, 3) or BGRA (H, W, 4) uint8 -> PNG bytes."""
    if img.dtype != np.uint8:
        raise TypeError(f"PNG: encodes uint8 images, got {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.ndim == 2:
        ctype, pix = 0, img[..., None]
    elif img.ndim == 3 and img.shape[2] == 3:
        ctype, pix = 2, img[..., ::-1]
    elif img.ndim == 3 and img.shape[2] == 4:
        ctype, pix = 6, img[..., [2, 1, 0, 3]]
    else:
        raise ValueError(f"PNG: cannot encode an image of shape {img.shape}")
    h, w = img.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), pix.reshape(h, -1)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)
    return SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b"")
