"""The eval slices end to end: the shipped test_NAFNet_5d.yml, test_Restormer_5d.yml,
test_PromptIR_5d.yml and test_SwinIR_5d.yml through the PyTorch port's test_pipeline and through
dcpt_tpu's, on the same synthetic data and one shared torch checkpoint per net
(num_gpu 0, a tiny width and depth)."""

import os

import cv2
import numpy as np
import pytest
import torch

from dcpt_tpu.data import build_dataset as jax_build_dataset
from dcpt_tpu.test import test_pipeline as jax_test_pipeline
from dcpt_tpu_torch.archs import build_network
from dcpt_tpu_torch.archs.nafnet_arch import NAFNetBaseline
from dcpt_tpu_torch.data import build_dataset
from dcpt_tpu_torch.test import test_pipeline as port_test_pipeline
from dcpt_tpu_torch.utils.options import yaml_load

YML = os.path.join(os.path.dirname(__file__), "..", "options", "all_in_one", "test", "test_NAFNet_5d.yml")
# the shipped Restormer and PromptIR eval ymls, each with tiny network overrides
# (PromptIR's as tests/test_pipeline_all_archs.py's: its prompts are 64/128/320 wide at any dim)
TRANSFORMER_YMLS = {
    "test_Restormer_5d.yml": {"type": "Restormer", "dim": 8, "num_blocks": [1, 1, 1, 1], "num_refinement_blocks": 1,
                              "heads": [1, 2, 2, 4]},
    "test_PromptIR_5d.yml": {"type": "PromptIR", "dim": 48, "num_blocks": [1, 1, 1, 1], "num_refinement_blocks": 1,
                             "heads": [1, 2, 4, 8]},
    # window 8 and img_size 128 as shipped, so the second block of each RSTB is shifted by 4
    "test_SwinIR_5d.yml": {"type": "SwinIR", "embed_dim": 12, "depths": [2, 2], "num_heads": [2, 2]},
}
TINY = ["network_g:width=8", "network_g:enc_blk_nums=[1,1]", "network_g:middle_blk_num=1",
        "network_g:dec_blk_nums=[1,1]"]
SIZES = [(32, 32), (24, 40)]  # the second one is reflect-padded to 32 x 48


def _write_datasets(root):
    """Two PNG pairs per dataset of the yml; returns the --force_yml dataroot overrides."""
    rng = np.random.default_rng(3)
    force = []
    for key, ds in yaml_load(YML)["datasets"].items():
        gt_dir, lq_dir = root / key / "gt", root / key / "lq"
        os.makedirs(gt_dir)
        has_lq = "dataroot_lq" in ds
        for i, (h, w) in enumerate(SIZES):
            gt = (rng.random((h, w, 3)) * 255).astype(np.uint8)
            cv2.imwrite(str(gt_dir / f"img{i}.png"), gt)
            if has_lq:
                os.makedirs(lq_dir, exist_ok=True)
                name = f"img{i}_hazy.png" if ds["type"] == "PairedImageDehazeDataset" else f"img{i}.png"
                cv2.imwrite(str(lq_dir / name), cv2.GaussianBlur(gt, (3, 3), 1))
        force.append(f"datasets:{key}:dataroot_gt={gt_dir}")
        if has_lq:
            force.append(f"datasets:{key}:dataroot_lq={lq_dir}")
    return force


def _checkpoint(path):
    """Seeded weights with random beta / gamma / LayerNorm affines, saved as the reference does."""
    torch.manual_seed(0)
    net = NAFNetBaseline(width=8, middle_blk_num=1, enc_blk_nums=[1, 1], dec_blk_nums=[1, 1])
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith(("beta", "gamma")) or ".norm" in name:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.5 + (1.0 if name.endswith("norm1.weight") or
                                                                    name.endswith("norm2.weight") else 0.0))
    torch.save({"params_ema": net.state_dict()}, path)


@pytest.fixture(scope="module")
def run_args(tmp_path_factory):
    root = tmp_path_factory.mktemp("slice")
    force = _write_datasets(root)
    _checkpoint(str(root / "net.pth"))
    return root, ["-opt", YML, "--force_yml", "num_gpu=0", *TINY, f"path:pretrain_network_g={root / 'net.pth'}",
                  *force]


def test_port_pipeline_matches_dcpt_tpu(run_args):
    root, args = run_args
    ours = port_test_pipeline(str(root / "torch"), args=args)
    ref = jax_test_pipeline(str(root / "jax"), args=args)
    assert set(ours) == set(ref) == {"Rain100L", "CBSD68", "SOTS", "deblur", "LowLight"}
    for name in ref:
        assert np.isfinite(ours[name]["psnr"]) and np.isfinite(ours[name]["ssim"])
        # the gap is uint8 rounding flips of the two frameworks' float outputs
        assert abs(ours[name]["psnr"] - ref[name]["psnr"]) <= 0.01, (name, ours[name], ref[name])
        assert abs(ours[name]["ssim"] - ref[name]["ssim"]) <= 1e-4, (name, ours[name], ref[name])


def test_datasets_give_dcpt_tpus_samples(run_args):
    """Each dataset type yields exactly dcpt_tpu's arrays (decode, colour order, seeded noise)."""
    _, args = run_args
    force = dict(a.split("=", 1) for a in args if a.startswith("datasets:"))
    for key, ds in yaml_load(YML)["datasets"].items():
        opt = dict(ds, phase="test", scale=1, dataroot_gt=force[f"datasets:{key}:dataroot_gt"])
        if "dataroot_lq" in ds:
            opt["dataroot_lq"] = force[f"datasets:{key}:dataroot_lq"]
        ours, ref = build_dataset(opt), jax_build_dataset(opt)
        by_path = {ref[i]["lq_path"]: ref[i] for i in range(len(ref))}
        assert len(ours) == len(ref)
        for i in range(len(ours)):
            sample = ours[i]
            want = by_path[sample["lq_path"]]
            for k in ("lq", "gt"):
                np.testing.assert_array_equal(sample[k].numpy(), want[k].transpose(2, 0, 1), err_msg=f"{key} {k}")


def test_num_gpu_without_cuda_raises(run_args):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    root, args = run_args
    args = [a if a != "num_gpu=0" else "num_gpu=1" for a in args]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_test_pipeline(str(root / "cuda"), args=args)


def _transformer_checkpoint(path, net_opt):
    """Seeded weights of a tiny Restormer / PromptIR / SwinIR with random LayerNorm
    affines and temperatures, saved under params_ema as the reference does."""
    torch.manual_seed(0)
    net = build_network(net_opt)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if ".norm" in name or name.endswith("temperature"):
                p.copy_(torch.rand(p.shape, generator=gen) + 0.5 if name.endswith(("weight", "temperature"))
                        else torch.randn(p.shape, generator=gen) * 0.3)
    torch.save({"params_ema": net.state_dict()}, path)


@pytest.mark.parametrize("yml", list(TRANSFORMER_YMLS))
def test_transformer_pipelines_match_dcpt_tpu(yml, run_args):
    """PSNR within 0.01 dB and SSIM within 1e-4 of dcpt_tpu's pipeline on the same checkpoint."""
    root, args = run_args
    net_opt = TRANSFORMER_YMLS[yml]
    ckpt = root / f"{net_opt['type']}.pth"
    _transformer_checkpoint(str(ckpt), net_opt)
    path = os.path.join(os.path.dirname(YML), yml)
    force = [a for a in args[3:] if a.startswith(("datasets:", "num_gpu"))]
    network = [f"network_g:{k}={v}".replace(" ", "") for k, v in net_opt.items() if k != "type"]
    args = ["-opt", path, "--force_yml", *force, *network, f"path:pretrain_network_g={ckpt}"]
    ours = port_test_pipeline(str(root / f"torch_{net_opt['type']}"), args=args)
    ref = jax_test_pipeline(str(root / f"jax_{net_opt['type']}"), args=args)
    assert set(ours) == set(ref) == {"Rain100L", "CBSD68", "SOTS", "deblur", "LowLight"}
    for name in ref:
        assert np.isfinite(ours[name]["psnr"]) and np.isfinite(ours[name]["ssim"])
        assert abs(ours[name]["psnr"] - ref[name]["psnr"]) <= 0.01, (name, ours[name], ref[name])
        assert abs(ours[name]["ssim"] - ref[name]["ssim"]) <= 1e-4, (name, ours[name], ref[name])
