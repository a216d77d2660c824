"""The SwinIR DCPT pre-training step of the PyTorch port against dcpt_tpu's, on the CPU.

A tiny SwinIR (embed 12, two RSTBs of two blocks with 2 heads, window 8 at
img_size 128, so every second block is shifted by 4 and attends across the
seam of the 32 x 32 crops) tapped at ``encode_layers``, as
``train_SwinIR_dcpt_5d.yml`` taps it, feeds a PromptIR_NoImg_DC probe with
the yml's ``downsample``: one RSTB in the encoder, so one tap.  On the CPU every
SwinTransformerBlock runs through ``SwinBlockFunction`` with K9's plain
version as its backward, so three steps check that decomposition inside the
whole step.  Then ``train_pipeline`` runs the shipped yml at that size on
synthetic PNGs, keeps one training state, saves and resumes; the shipped
yml's full width runs on the card (``chip_smoke.py`` [15]).
"""

import os

import pytest

import _torch_threads  # noqa: F401
from dcpt_tpu_torch.ops import window_attention as wa
from dcpt_tpu_torch.train import train_pipeline
from test_torch_dcpt import _write_train_sets, three_transformer_steps

YML = os.path.join(os.path.dirname(__file__), "..", "options", "all_in_one", "train", "train_SwinIR_dcpt_5d.yml")
NETWORK_G = {"type": "SwinIR", "embed_dim": 12, "depths": [2, 2], "num_heads": [2, 2], "window_size": 8,
             "mlp_ratio": 2.0, "upscale": 1, "h": 32}
NETWORK_DC = {"type": "PromptIR_NoImg_DC", "feature_dims": [12], "num_res_blocks": 1, "num_classes": 5,
              "downsample": True}


def _key_bias(name):
    """The key part of a qkv bias: each shifts every logit of a query's row alike,
    which its softmax ignores, so its gradient is zero in exact arithmetic."""
    c = NETWORK_G["embed_dim"]
    return slice(c, 2 * c) if name.endswith("attn.qkv.bias") else None


def test_three_steps_match_dcpt_tpu(tmp_path):
    three_transformer_steps(tmp_path, NETWORK_G, NETWORK_DC, "encode_layers", n_taps=1, exact_zero=_key_bias)


def test_train_pipeline_saves_and_resumes(tmp_path, monkeypatch):
    """The shipped yml at embed 12 on the CPU: 4 iterations saving every 2 with
    ``logger.keep_checkpoints`` 1, then --auto_resume for 2 more.  Per step the
    Swin blocks run 8 forwards (both passes through all 4 blocks) and 6
    backwards (the skip-tail pass reaches the loss through encode_layers.0's
    2 blocks alone): at the shipped 6 x 6 blocks, 72 and 36 + 18 = 54."""
    calls = {"forward": 0, "backward": 0}
    for name in calls:
        real = getattr(wa.SwinBlockFunction, name)

        def counted(ctx, *args, _real=real, _name=name):
            calls[_name] += 1
            return _real(ctx, *args)

        monkeypatch.setattr(wa.SwinBlockFunction, name, staticmethod(counted))
    force = _write_train_sets(tmp_path / "data")
    common = ["-opt", YML, "--force_yml", "num_gpu=0", "network_g:embed_dim=12", "network_g:depths=[2,2]",
              "network_g:num_heads=[2,2]", "network_dc:feature_dims=[12]", "network_dc:num_res_blocks=1",
              "datasets:train:gt_size=32", "datasets:train:batch_size_per_gpu=2",
              "datasets:train:num_worker_per_gpu=0", "datasets:train:datasets:d3_dehaze:suffix=.png",
              "logger:use_tb_logger=false", "logger:print_freq=2", "logger:save_checkpoint_freq=2",
              "logger:keep_checkpoints=1", "train:scheduler:periods=[6]", *force]
    model = train_pipeline(str(tmp_path), args=common + ["train:total_iter=4"])
    assert calls == {"forward": 8 * 4, "backward": 6 * 4}
    exp = tmp_path / "experiments" / "SwinIR_dcpt_5d_pretrain"
    assert (exp / "models" / "net_g_4.pth").exists() and (exp / "models" / "net_dc_4.pth").exists()
    assert sorted(p.name for p in (exp / "training_states").iterdir()) == ["4.state"]
    assert set(model.log_dict) == {"l_pix", "l_classify"}
    assert all(v == pytest.approx(v) for v in model.log_dict.values())  # finite
    resumed = train_pipeline(str(tmp_path), args=["--auto_resume", *common, "train:total_iter=6"])
    assert resumed.optimizer_g.state_dict()["state"][0]["step"].item() == 6
    assert sorted(p.name for p in (exp / "training_states").iterdir()) == ["6.state"]
    assert (exp / "models" / "net_g_latest.pth").exists()
