"""Crop and augment primitives (dcpt_tpu/data/transforms.py), numpy HWC.

The random draws are python ``random``'s, in the reference's order, so a
seeded run crops and flips as dcpt_tpu's does.
"""

from __future__ import annotations

import random

import numpy as np


def mod_crop(img: np.ndarray, scale: int) -> np.ndarray:
    """Crop H, W down to multiples of scale (reference: transforms.py:7-24)."""
    if img.ndim not in (2, 3):
        raise ValueError(f"Wrong img ndim: {img.ndim}.")
    h, w = img.shape[0], img.shape[1]
    return img[: h - h % scale, : w - w % scale, ...].copy()


def center_crop(img: np.ndarray, size: int) -> np.ndarray:
    """Centred size x size crop (reference: transforms.py:27-45)."""
    if img.ndim not in (2, 3):
        raise ValueError(f"Wrong img ndim: {img.ndim}.")
    h, w = img.shape[0], img.shape[1]
    return img[(h - size) // 2 : (h + size) // 2, (w - size) // 2 : (w + size) // 2, ...].copy()


def paired_random_crop(img_gts, img_lqs, gt_patch_size: int, scale: int, gt_path=None):
    """Scale-aware paired random crop of one image or a list (reference: transforms.py:48-129)."""
    single_gt, single_lq = not isinstance(img_gts, list), not isinstance(img_lqs, list)
    img_gts = [img_gts] if single_gt else img_gts
    img_lqs = [img_lqs] if single_lq else img_lqs
    h_lq, w_lq = img_lqs[0].shape[0:2]
    h_gt, w_gt = img_gts[0].shape[0:2]
    lq_patch_size = gt_patch_size // scale
    if h_gt != h_lq * scale or w_gt != w_lq * scale:
        raise ValueError(f"Scale mismatches. GT ({h_gt}, {w_gt}) is not {scale}x multiplication of LQ ({h_lq}, {w_lq}).")
    if h_lq < lq_patch_size or w_lq < lq_patch_size:
        raise ValueError(f"LQ ({h_lq}, {w_lq}) is smaller than patch size ({lq_patch_size}, {lq_patch_size}). "
                         f"Please remove {gt_path}.")
    top = random.randint(0, h_lq - lq_patch_size)
    left = random.randint(0, w_lq - lq_patch_size)
    img_lqs = [v[top : top + lq_patch_size, left : left + lq_patch_size, ...] for v in img_lqs]
    top_gt, left_gt = top * scale, left * scale
    img_gts = [v[top_gt : top_gt + gt_patch_size, left_gt : left_gt + gt_patch_size, ...] for v in img_gts]
    return (img_gts[0] if len(img_gts) == 1 else img_gts), (img_lqs[0] if len(img_lqs) == 1 else img_lqs)


def augment(imgs, hflip: bool = True, rotation: bool = True):
    """One draw of {horizontal flip, vertical flip, none} and one of the transpose
    "rotation", shared by every image of the list (reference: transforms.py:132-195;
    dcpt_tpu draws both whatever the flags say, and so does this)."""
    flip_ran = random.randint(0, 2)
    rot_ran = random.randint(0, 3)

    def _augment(img):
        if flip_ran == 0:
            img = img[:, ::-1, ...]
        elif flip_ran == 1:
            img = img[::-1, :, ...]
        if rot_ran != 0:
            img = img.transpose(1, 0, 2) if img.ndim == 3 else img.transpose(1, 0)
        return img.copy()

    if not isinstance(imgs, list):
        return _augment(imgs)
    out = [_augment(img) for img in imgs]
    return out[0] if len(out) == 1 else out
