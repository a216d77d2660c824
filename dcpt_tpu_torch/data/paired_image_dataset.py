"""Paired restoration datasets (dcpt_tpu/data/paired_image_dataset.py).

Each sample is ``{"lq", "gt"}`` CHW RGB float32 tensors plus their paths.
Semantics follow the JAX package exactly: in the train phase a paired random
crop of ``gt_size`` and the flip / transpose augmentation (python ``random``);
the denoise set adds Gaussian noise seeded ``np.random.seed(index)`` in train
and ``np.random.seed(0)`` in val/test (reference paired_image_dataset.py:
390-402); the dehaze set derives the GT name as ``lq_name.split('_')[0] +
suffix``.
"""

from __future__ import annotations

import os
import random

import numpy as np

from ..utils.file_client import FileClient
from ..utils.img_util import imfrombytes, img2tensor
from ..utils.registry import DATASET_REGISTRY
from .data_util import paired_paths_from_folder, paths_from_folder
from .transforms import augment, center_crop, paired_random_crop


class _BaseDataset:
    """Shared plumbing: disk reads, decode flag, the train crop or the eval centre crop."""

    def __init__(self, opt: dict):
        self.opt = opt
        self.train = opt["phase"] == "train"
        self.gt_size = opt.get("gt_size", 128)
        unported = [k for k in ("mean", "std", "prctile_norm", "meta_info_file") if opt.get(k)]
        if unported or not opt.get("decode", True) or opt["io_backend"]["type"] != "disk":
            raise NotImplementedError("dataset options not ported to dcpt_tpu_torch yet: mean / std / prctile_norm / "
                                      f"meta_info_file {unported}, decode: false, or a backend other than disk")
        self.io_backend_opt = dict(opt["io_backend"])
        self.file_client = None
        self.center_crop = opt.get("center_crop")
        self.flag = "grayscale" if opt.get("color") == "y" else "color"

    def _read(self, path: str) -> np.ndarray:
        if self.file_client is None:
            backend_opt = dict(self.io_backend_opt)
            self.file_client = FileClient(backend_opt.pop("type"), **backend_opt)
        return imfrombytes(self.file_client.get(path), flag=self.flag, float32=True, path=path)

    def _crop(self, img_gt, img_lq, gt_path, scale: int = 1):
        if self.train:
            img_gt, img_lq = paired_random_crop(img_gt, img_lq, self.gt_size, scale, gt_path)
            return augment([img_gt, img_lq], self.opt["use_hflip"], self.opt["use_rot"])
        if self.center_crop is not None:
            img_gt = center_crop(img_gt, self.center_crop)
            img_lq = center_crop(img_lq, self.center_crop)
        return img_gt, img_lq

    @staticmethod
    def _bgr2rgb(img_gt, img_lq):
        if img_gt.shape[-1] == img_lq.shape[-1] == 3:
            return img_gt[..., ::-1], img_lq[..., ::-1]
        return img_gt, img_lq

    def _finish(self, img_gt, img_lq, lq_path, gt_path) -> dict:
        """float32 CHW tensors."""
        img_gt = np.ascontiguousarray(img_gt, dtype=np.float32)
        img_lq = np.ascontiguousarray(img_lq, dtype=np.float32)
        img_gt, img_lq = img2tensor([img_gt, img_lq], bgr2rgb=False)
        return {"lq": img_lq, "gt": img_gt, "lq_path": lq_path, "gt_path": gt_path}


@DATASET_REGISTRY.register()
class PairedImageDataset(_BaseDataset):
    """LQ/GT pairs from two folders (reference: paired_image_dataset.py:26-195)."""

    def __init__(self, opt):
        super().__init__(opt)
        self.scale = opt["scale"]
        self.paths = paired_paths_from_folder([opt["dataroot_lq"], opt["dataroot_gt"]], ["lq", "gt"],
                                              opt.get("filename_tmpl", "{}"))

    def __getitem__(self, index):
        gt_path = self.paths[index]["gt_path"]
        lq_path = self.paths[index]["lq_path"]
        img_gt, img_lq = self._crop(self._read(gt_path), self._read(lq_path), gt_path, self.scale)
        if not self.train:
            img_gt = img_gt[0 : img_lq.shape[0] * self.scale, 0 : img_lq.shape[1] * self.scale, ...]
        img_gt, img_lq = self._bgr2rgb(img_gt, img_lq)
        return self._finish(img_gt, img_lq, lq_path, gt_path)

    def __len__(self):
        return len(self.paths)


@DATASET_REGISTRY.register()
class PairedImageDenoiseDataset(_BaseDataset):
    """GT only, plus Gaussian noise of ``sigma_range`` / 255 (reference: paired_image_dataset.py:277-424)."""

    def __init__(self, opt):
        super().__init__(opt)
        self.sigma_type = opt["sigma_type"]
        self.sigma_range = opt["sigma_range"]
        if self.sigma_type not in ("constant", "random", "choice"):
            raise ValueError(f"sigma_type must be constant, random or choice, got {self.sigma_type}")
        self.paths = paths_from_folder(opt["dataroot_gt"])

    def __getitem__(self, index):
        gt_path = self.paths[index]
        img_gt = self._read(gt_path)
        img_gt, img_lq = self._crop(img_gt, img_gt.copy(), gt_path)
        img_gt, img_lq = self._bgr2rgb(img_gt, img_lq)
        if self.sigma_type == "constant":
            sigma_value = self.sigma_range
        elif self.sigma_type == "random":
            sigma_value = random.uniform(self.sigma_range[0], self.sigma_range[1])
        else:
            sigma_value = random.choice(self.sigma_range)
        # the reference's seeding: per index in train, 0 in val/test (paired_image_dataset.py:397-402)
        np.random.seed(seed=index if self.train else 0)
        img_lq = img_lq + np.random.normal(0, sigma_value / 255.0, img_lq.shape)
        return self._finish(img_gt, img_lq, gt_path, gt_path)

    def __len__(self):
        return len(self.paths)


@DATASET_REGISTRY.register()
class PairedImageDehazeDataset(_BaseDataset):
    """Hazy inputs with GT = ``lq_name.split('_')[0] + suffix`` (reference: paired_image_dataset.py:584-732)."""

    def __init__(self, opt):
        super().__init__(opt)
        self.gt_folder = opt["dataroot_gt"]
        self.paths = paths_from_folder(opt["dataroot_lq"])
        self.suffix = opt.get("suffix", ".jpg")

    def __getitem__(self, index):
        lq_path = self.paths[index]
        img_lq = self._read(lq_path)
        gt_path = os.path.join(self.gt_folder, lq_path.split("/")[-1].split("_")[0] + self.suffix)
        img_gt, img_lq = self._crop(self._read(gt_path), img_lq, gt_path)
        img_gt, img_lq = self._bgr2rgb(img_gt, img_lq)
        return self._finish(img_gt, img_lq, gt_path, gt_path)

    def __len__(self):
        return len(self.paths)
