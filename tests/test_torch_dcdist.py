"""DCPT's stage-3 fine-tune (``DCDistModel``) of the PyTorch port against
dcpt_tpu's, on the CPU.

A width-8 two-level NAFNet and a frozen two-level PromptIR_NoImg_DC classifier
start from the same weights in both packages (``_torch_dc_util``) and take the
same three seeded batches: one forward of the NAFNet gives the output (L1
against gt) and the taps, which pass through the frozen classifier (cross
entropy x 0.1); the NAFNet trains (AdamW, lr 1e-4) with its EMA (decay 0.9),
the classifier keeps every bit.  On the CPU every NAFBlock runs through the
port's autograd Function with K2's plain version as its backward, each tapped
block's cotangent summed from the next block and from the classifier.
"""

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401
from _torch_dc_util import (Loader, assert_states_close, batches, jax_model, jax_steps, jax_tree, mixed_bar, options,
                            port_model, port_steps, seeded_weights, to_torch)
from dcpt_tpu_torch.models.degradation_classification_distillation_model import center_crop_tv


@pytest.fixture(scope="module")
def dist(tmp_path_factory):
    """The weights, dcpt_tpu's DCDistModel on them, and its fp32 and bf16 three-step runs."""
    weights = seeded_weights()
    jmodel = jax_model(options(tmp_path_factory.mktemp("jax"), "DCDistModel"), weights)
    runs = {mixed: jax_steps(jmodel, "DCDistModel", weights, batches(), mixed) for mixed in (False, True)}
    return weights, jmodel, runs


def test_three_steps_match_dcpt_tpu(tmp_path, dist):
    """``l_pixel`` and ``l_classify`` at every step within rtol 1e-4; the NAFNet
    and its EMA afterwards within rtol 1e-4 / atol 1e-5 of dcpt_tpu's; the
    classifier bit for bit unchanged, without gradients, and in no optimizer."""
    weights, _, runs = dist
    want_losses, want_g, want_ema = runs[False]
    model = port_model(options(tmp_path, "DCDistModel"), weights)
    before = {k: v.clone() for k, v in model.net_dc.state_dict().items()}
    losses = port_steps(model, batches())
    for it, (got, want) in enumerate(zip(losses, want_losses), start=1):
        assert set(got) == set(want) == {"l_pixel", "l_classify"}
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=f"step {it} {k}")
    assert_states_close(model.net_g.state_dict(), want_g)
    assert_states_close(model.net_g_ema.state_dict(), want_ema)
    assert all(torch.equal(v, before[k]) for k, v in model.net_dc.state_dict().items())
    assert all(p.grad is None and not p.requires_grad for p in model.net_dc.parameters())
    assert model.optimizers == [model.optimizer_g]


def test_three_mixed_steps_match_dcpt_tpu(tmp_path, dist):
    """``train.mixed_precision``: both nets on bf16 copies of their fp32 masters,
    held to dcpt_tpu's bf16 run by ``mixed_bar``; the masters stay fp32."""
    weights, _, runs = dist
    model = port_model(options(tmp_path, "DCDistModel", mixed_precision=True), weights)
    losses = port_steps(model, batches())
    mixed_bar(losses, model.net_g.state_dict(), runs[True][:2], runs[False][:2])
    assert {p.dtype for p in model.net_g.parameters()} == {torch.float32}


def test_dataset_idx_broadcast_from_the_yml(tmp_path, dist):
    """With a top-level ``dataset_idx`` the label of every image is that
    constant, whatever the batch says, and the step's losses are dcpt_tpu's."""
    weights, jmodel, _ = dist
    opt = options(tmp_path, "DCDistModel")
    opt["dataset_idx"] = 3
    model = port_model(opt, weights)
    data = batches(n=1)
    assert set(data[0]["dataset_idx"]) != {3}
    jmodel.opt["dataset_idx"] = 3
    try:
        want_losses, _, _ = jax_steps(jmodel, "DCDistModel", weights, data)
    finally:
        del jmodel.opt["dataset_idx"]
    losses = port_steps(model, data)
    assert model.dataset_idx.tolist() == [3, 3] and np.asarray(jmodel.dataset_idx).tolist() == [3, 3]
    for k, v in want_losses[0].items():
        np.testing.assert_allclose(losses[0][k], v, rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("shape", [(2, 3, 101, 90), (1, 3, 127, 200), (1, 3, 200, 131)])
def test_center_crop_matches_dcpt_tpu(shape):
    """torchvision's center crop to 128: zero padding on a side below 128 (odd
    and even shortfalls), the crop at round((dim - 128) / 2) on a side above."""
    from dcpt_tpu.models.degradation_classification_distillation_model import center_crop_tv as jax_crop

    x = np.random.default_rng(2).random(shape).astype(np.float32)
    got = center_crop_tv(torch.from_numpy(x), 128)
    want = np.asarray(jax_crop(x.transpose(0, 2, 3, 1), 128)).transpose(0, 3, 1, 2)
    assert got.shape[-2:] == (128, 128)
    np.testing.assert_array_equal(got.numpy(), want)


def test_psnr_ssim_validation_matches_dcpt_tpu(tmp_path, dist):
    """PSNR / SSIM on the EMA net at batch 2 (18 x 18 images, padded to 20 and
    cropped back), with the reference's quirk of accumulating the metrics once
    per image path over the whole batch: within 1e-4 dB (and 1e-6 SSIM) of
    dcpt_tpu's; the unclamped run leaves the best results alone."""
    weights, jmodel, _ = dist
    model = port_model(options(tmp_path, "DCDistModel"), weights)
    jmodel.params_g_ema = jax_tree(jmodel, "g", weights["g"])
    data = batches(n=2, b=2, hw=18, seed=6)
    loader = Loader([to_torch(b) for b in data], name="val_set")
    jmodel.nondist_validation(Loader(data, name="val_set"), 5, None, False)
    model.nondist_validation(loader, 5, None, False)
    assert set(model.metric_results) == {"psnr", "ssim"}
    assert model.metric_results["psnr"] == pytest.approx(jmodel.metric_results["psnr"], abs=1e-4)
    assert model.metric_results["ssim"] == pytest.approx(jmodel.metric_results["ssim"], abs=1e-6)
    best = {k: dict(v) for k, v in model.best_metric_results["val_set"].items()}
    assert best["psnr"]["iter"] == 5 and best["psnr"]["val"] == model.metric_results["psnr"]
    model.validation(loader, 6, None, clamp=False, dataset_idx=1)
    assert model.best_metric_results["val_set"] == best
