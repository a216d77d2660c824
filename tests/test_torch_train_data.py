"""Training data of the PyTorch port against dcpt_tpu's: crops and flips under
the same python ``random`` seed, the denoise set's seeded noise, ConcatDataset's
order and ``dataset_idx``, and EnlargedSampler's index order."""

import os
import random

import cv2
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401
from dcpt_tpu.data import build_dataset as jax_build_dataset
from dcpt_tpu.data.concat_dataset import ConcatDataset as JaxConcat
from dcpt_tpu.data.data_sampler import EnlargedSampler as JaxSampler
from dcpt_tpu.data.transforms import augment as jax_augment
from dcpt_tpu.data.transforms import mod_crop as jax_mod_crop
from dcpt_tpu.data.transforms import paired_random_crop as jax_crop
from dcpt_tpu.train import _build_train_dataset as jax_build_train_dataset
from dcpt_tpu_torch.data import ConcatDataset, EnlargedSampler, build_dataloader, build_dataset
from dcpt_tpu_torch.data.transforms import augment, mod_crop, paired_random_crop
from dcpt_tpu_torch.train import _build_train_dataset


def test_crop_and_augment_match_under_one_seed():
    rng = np.random.default_rng(0)
    gt = rng.random((40, 36, 3)).astype(np.float32)
    lq = rng.random((20, 18, 3)).astype(np.float32)
    for seed in range(6):
        random.seed(seed)
        ours = augment(list(paired_random_crop(gt, lq, 16, 2, "x")), True, True)
        random.seed(seed)
        ref = jax_augment(list(jax_crop(gt, lq, 16, 2, "x")), True, True)
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(mod_crop(gt, 3), jax_mod_crop(gt, 3))
    with pytest.raises(ValueError, match="smaller than patch"):
        paired_random_crop(gt, lq, 64, 2)


@pytest.fixture(scope="module")
def train_sets(tmp_path_factory):
    """A denoise set (gt only), a paired set and a dehaze set of 24 x 24 PNGs; their train-phase opts."""
    root = tmp_path_factory.mktemp("train_sets")
    rng = np.random.default_rng(1)
    for sub in ("noise/gt", "pair/gt", "pair/lq", "haze/gt", "haze/lq"):
        os.makedirs(root / sub)
    for i in range(3):
        for sub in ("noise/gt", "pair/gt", "pair/lq"):
            cv2.imwrite(str(root / sub / f"im{i}.png"), (rng.random((24, 24, 3)) * 255).astype(np.uint8))
        cv2.imwrite(str(root / "haze/gt" / f"h{i}.png"), (rng.random((24, 24, 3)) * 255).astype(np.uint8))
        for j in range(2):
            cv2.imwrite(str(root / "haze/lq" / f"h{i}_{j}.png"), (rng.random((24, 24, 3)) * 255).astype(np.uint8))
    common = {"phase": "train", "scale": 1, "gt_size": 16, "use_hflip": True, "use_rot": True,
              "io_backend": {"type": "disk"}}
    return {
        "b_noise": dict(common, name="n", type="PairedImageDenoiseDataset", dataroot_gt=str(root / "noise/gt"),
                        sigma_type="choice", sigma_range=[15, 25, 50]),
        "a_pair": dict(common, name="p", type="PairedImageDataset", dataroot_gt=str(root / "pair/gt"),
                       dataroot_lq=str(root / "pair/lq")),
        "c_haze": dict(common, name="h", type="PairedImageDehazeDataset", dataroot_gt=str(root / "haze/gt"),
                       dataroot_lq=str(root / "haze/lq"), suffix=".png"),
    }


def _same_sample(ours, ref, what):
    for k in ("lq", "gt"):
        np.testing.assert_array_equal(ours[k].numpy(), ref[k].transpose(2, 0, 1), err_msg=f"{what} {k}")


def test_train_samples_equal_dcpt_tpus(train_sets):
    """Each dataset in the train phase, the same python ``random`` state: the same
    files, crops, flips and (denoise) noise seeded np.random.seed(index)."""
    for name, opt in train_sets.items():
        ours, ref = build_dataset(opt), jax_build_dataset(opt)
        assert len(ours) == len(ref)
        for i in range(len(ours)):
            random.seed(10 * i)
            got = ours[i]
            random.seed(10 * i)
            want = ref[i]
            assert got["gt_path"] == want["gt_path"]
            _same_sample(got, want, f"{name}[{i}]")
            assert got["lq"].shape == (3, 16, 16)


def test_concat_order_and_dataset_idx(train_sets):
    """Sub-datasets in sorted key order, as dcpt_tpu/train.py:60 builds them; the
    same samples with the same ``dataset_idx`` under the same seeds."""
    cat_opt = {"type": "ConcatDataset", "phase": "train", "scale": 1, "gt_size": 16, "use_hflip": True,
               "use_rot": True, "datasets": {k: {kk: vv for kk, vv in v.items() if kk not in ("phase", "scale")}
                                             for k, v in train_sets.items()}}
    ours, ref = _build_train_dataset(cat_opt), jax_build_train_dataset(cat_opt)
    assert isinstance(ours, ConcatDataset) and isinstance(ref, JaxConcat)
    assert ours.cumulative_sizes == ref.cumulative_sizes
    for idx in range(len(ours)):
        random.seed(idx)
        got = ours[idx]
        random.seed(idx)
        want = ref[idx]
        assert got["dataset_idx"] == want["dataset_idx"] and got["lq_path"] == want["lq_path"]
        _same_sample(got, want, f"concat[{idx}]")
    assert [ours[i]["dataset_idx"] for i in range(len(ours))] == [0, 0, 0, 1, 1, 1, 2, 2, 2, 2, 2, 2]


@pytest.mark.parametrize("torch_compat", [False, True])
def test_enlarged_sampler_order_equals_dcpt_tpus(torch_compat):
    data = list(range(23))
    for epoch in (0, 1, 7):
        for replicas, rank, ratio in ((1, 0, 1), (1, 0, 3), (4, 2, 2)):
            ours = EnlargedSampler(data, replicas, rank, ratio, torch_compat=torch_compat)
            ref = JaxSampler(data, replicas, rank, ratio, torch_compat=torch_compat)
            ours.set_epoch(epoch)
            ref.set_epoch(epoch)
            assert list(ours) == list(ref) and len(ours) == len(ref)


def test_train_loader_batches_with_dataset_idx(train_sets):
    """The train loader: batch_size_per_gpu per step, drop_last, the sampler's order."""
    cat_opt = {"type": "ConcatDataset", "phase": "train", "scale": 1, "gt_size": 16, "use_hflip": True,
               "use_rot": True, "batch_size_per_gpu": 4, "num_worker_per_gpu": 0, "datasets": train_sets}
    ds = _build_train_dataset(cat_opt)
    sampler = EnlargedSampler(ds, 1, 0, 1)
    batches = list(build_dataloader(ds, cat_opt, num_gpu=0, sampler=sampler, seed=0))
    assert len(batches) == len(ds) // 4
    order = list(sampler)
    want_idx = [ds[i]["dataset_idx"] for i in order][: 4 * len(batches)]
    assert torch.cat([b["dataset_idx"] for b in batches]).tolist() == want_idx
    assert batches[0]["lq"].shape == (4, 3, 16, 16) and batches[0]["gt"].dtype == torch.float32
