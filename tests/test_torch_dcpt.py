"""The DCPT pre-training step of the PyTorch port against dcpt_tpu's, on the CPU.

A width-8 NAFNet (enc [1, 1, 1, 1], dec [1, 1, 1, 1]) and a PromptIR_NoImg_DC
classifier (feature_dims [8, 16, 32, 64]) start from the same weights (dcpt_tpu's
init carried across with ``params_to_state_dict``) and take the same batches.
On the CPU every NAFBlock runs through the port's autograd Function with K2's
plain version as its backward, so the losses and parameters after three steps
check that decomposition inside the whole step.  Then ``train_pipeline`` runs
the shipped DCPT yml at that size on synthetic PNGs, saves and resumes.
"""

import os

import cv2
import numpy as np
import pytest
import torch

import jax

from dcpt_tpu.models import build_model as jax_build_model
from dcpt_tpu_torch.convert.jax_params import params_to_state_dict
from dcpt_tpu_torch.models import build_model
from dcpt_tpu_torch.train import train_pipeline
from dcpt_tpu_torch.utils.options import yaml_load

YML = os.path.join(os.path.dirname(__file__), "..", "options", "all_in_one", "train", "train_NAFNet_dcpt_5d.yml")
NETWORK_G = {"type": "NAFNetBaseline", "width": 8, "enc_blk_nums": [1, 1, 1, 1], "middle_blk_num": 1,
             "dec_blk_nums": [1, 1, 1, 1], "window_size": 16, "h": 32}
NETWORK_DC = {"type": "PromptIR_NoImg_DC", "feature_dims": [8, 16, 32, 64], "num_res_blocks": 1, "num_classes": 5}


def _opt(tmp_path, model_type):
    return {
        "name": "tiny_dcpt", "model_type": model_type, "scale": 1, "num_gpu": 0, "manual_seed": 0,
        "is_train": True, "dist": False, "rank": 0, "world_size": 1, "hook_names": "ups",
        "network_g": dict(NETWORK_G), "network_dc": dict(NETWORK_DC),
        "path": {"models": str(tmp_path / "models"), "training_states": str(tmp_path / "states"),
                 "log": str(tmp_path)},
        "train": {
            "optim_g": {"type": "AdamW", "lr": 1e-4, "weight_decay": 1e-4, "betas": [0.9, 0.999]},
            "optim_dc": {"type": "AdamW", "lr": 1e-4, "weight_decay": 1e-4, "betas": [0.9, 0.999]},
            "scheduler": {"type": "CosineAnnealingRestartLR", "periods": [10], "restart_weights": [1],
                          "eta_min": 1e-7},
            "pixel_opt": {"type": "L1Loss", "loss_weight": 1.0},
            "classify_opt": {"type": "CrossEntropyLoss", "loss_weight": 1.0},
            "total_iter": 3,
        },
    }


def _randomize(tree, rng, path=()):
    """beta, gamma, the LayerNorm affines and the mixing weights drawn at random
    (at init every NAFBlock is the identity and every norm the plain normaliser)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize(v, rng, path + (k,))
        elif k in ("beta", "gamma", "mixing_weights") or (path and "norm" in path[-1]):
            shift = 1.0 if (path and "norm" in path[-1] and k == "weight") else 0.0
            out[k] = (rng.normal(0.0, 0.5, np.shape(v)) + shift).astype(np.float32)
        else:
            out[k] = np.asarray(v, np.float32)
    return out


def _batches(n=3, b=2, hw=32):
    rng = np.random.default_rng(11)
    out = []
    for _ in range(n):
        gt = rng.random((b, hw, hw, 3)).astype(np.float32)
        lq = np.clip(gt * 0.8 + rng.normal(0, 0.05, gt.shape), 0, 1).astype(np.float32)
        out.append({"lq": lq, "gt": gt, "dataset_idx": rng.integers(0, 5, b)})
    return out


@pytest.mark.parametrize("model_type", ["DCPTModel", "DCTModel"])
def test_three_steps_match_dcpt_tpu(tmp_path, model_type):
    """Losses at every step within rtol 1e-4, and every parameter afterwards
    within rtol 1e-4 of dcpt_tpu's, with the shipped yml's AdamW (lr 1e-4,
    weight decay 1e-4).  atol is 1e-5, a tenth of one step: where a gradient is
    near Adam's eps (1e-8), the update lr * g / (|g| + eps) carries the two
    frameworks' float noise in g at full size (one element in 32768 here)."""
    jopt = _opt(tmp_path / "jax", model_type)
    jopt["num_gpu"] = 1
    jmodel = jax_build_model(jopt)
    rng = np.random.default_rng(0)
    pg = _randomize(jax.tree_util.tree_map(np.asarray, jmodel.params_g), rng)
    pdc = _randomize(jax.tree_util.tree_map(np.asarray, jmodel.params_dc), rng)
    jmodel.params_g = jax.tree_util.tree_map(jax.numpy.asarray, pg)
    jmodel.params_dc = jax.tree_util.tree_map(jax.numpy.asarray, pdc)

    model = build_model(_opt(tmp_path / "torch", model_type))
    model.net_g.load_state_dict(params_to_state_dict(pg, "NAFNetBaseline"), strict=True)
    model.net_dc.load_state_dict(params_to_state_dict(pdc, "PromptIR_NoImg_DC"), strict=True)

    for it, batch in enumerate(_batches(), start=1):
        jmodel.update_learning_rate(it)
        jmodel.feed_data(batch)
        jmodel.optimize_parameters(it)
        model.update_learning_rate(it)
        model.feed_data({"lq": torch.from_numpy(batch["lq"].transpose(0, 3, 1, 2).copy()),
                         "gt": torch.from_numpy(batch["gt"].transpose(0, 3, 1, 2).copy()),
                         "dataset_idx": torch.from_numpy(batch["dataset_idx"])})
        model.optimize_parameters(it)
        assert set(model.log_dict) == set(jmodel.log_dict) == {"l_pix", "l_classify"}
        for k, v in jmodel.log_dict.items():
            np.testing.assert_allclose(model.log_dict[k], v, rtol=1e-4, err_msg=f"step {it} {k}")
        assert model.get_current_learning_rate() == pytest.approx(jmodel.get_current_learning_rate())

    for net, params, arch in ((model.net_g, jmodel.params_g, "NAFNetBaseline"),
                              (model.net_dc, jmodel.params_dc, "PromptIR_NoImg_DC")):
        want = params_to_state_dict(jax.tree_util.tree_map(np.asarray, params), arch)
        got = net.state_dict()
        assert set(got) == set(want)
        for name, value in want.items():
            np.testing.assert_allclose(got[name].numpy(), value.numpy(), rtol=1e-4, atol=1e-5, err_msg=name)


def _write_train_sets(root):
    """Three 40 x 40 PNGs (pairs where the dataset has an lq folder) per dataset of the yml."""
    rng = np.random.default_rng(5)
    force = []
    for key, ds in yaml_load(YML)["datasets"]["train"]["datasets"].items():
        gt_dir, lq_dir = root / key / "gt", root / key / "lq"
        os.makedirs(gt_dir)
        for i in range(3):
            gt = (rng.random((40, 40, 3)) * 255).astype(np.uint8)
            cv2.imwrite(str(gt_dir / f"img{i}.png"), gt)
            if "dataroot_lq" in ds:
                os.makedirs(lq_dir, exist_ok=True)
                name = f"img{i}_hazy.png" if ds["type"] == "PairedImageDehazeDataset" else f"img{i}.png"
                cv2.imwrite(str(lq_dir / name), cv2.GaussianBlur(gt, (3, 3), 1))
        force.append(f"datasets:train:datasets:{key}:dataroot_gt={gt_dir}")
        if "dataroot_lq" in ds:
            force.append(f"datasets:train:datasets:{key}:dataroot_lq={lq_dir}")
    return force


def test_train_pipeline_saves_and_resumes(tmp_path):
    """The shipped yml at width 8 on the CPU: 4 iterations, a checkpoint at 4,
    then --auto_resume continues from it for 2 more."""
    force = _write_train_sets(tmp_path / "data")
    common = ["-opt", YML, "--force_yml", "num_gpu=0", "network_g:width=8", "network_g:enc_blk_nums=[1,1,1,1]",
              "network_g:dec_blk_nums=[1,1,1,1]", "network_dc:feature_dims=[8,16,32,64]",
              "datasets:train:gt_size=32", "datasets:train:batch_size_per_gpu=2",
              "datasets:train:num_worker_per_gpu=0", "datasets:train:datasets:d3_dehaze:suffix=.png",
              "logger:use_tb_logger=false", "logger:print_freq=2", "logger:save_checkpoint_freq=4",
              "train:scheduler:periods=[6]", *force]
    model = train_pipeline(str(tmp_path), args=common + ["train:total_iter=4"])
    exp = tmp_path / "experiments" / "NAFNet_dcpt_5d_pretrain"
    assert (exp / "models" / "net_g_4.pth").exists() and (exp / "models" / "net_dc_4.pth").exists()
    assert (exp / "training_states" / "4.state").exists()
    assert all(np.isfinite(v) for v in model.log_dict.values())
    resumed = train_pipeline(str(tmp_path), args=["--auto_resume", *common, "train:total_iter=6"])
    assert resumed.optimizer_g.state_dict()["state"][0]["step"].item() == 6
    assert (exp / "models" / "net_g_latest.pth").exists()
