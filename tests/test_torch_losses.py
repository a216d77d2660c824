"""Losses and the classifier's accuracy of the PyTorch port against dcpt_tpu's."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import _torch_threads  # noqa: F401
from dcpt_tpu.losses import build_loss as jax_build_loss
from dcpt_tpu_torch.losses import build_loss


@pytest.mark.parametrize("opt", [
    {"type": "L1Loss", "loss_weight": 0.5},
    {"type": "L1Loss", "reduction": "sum"},
    {"type": "MSELoss", "loss_weight": 2.0},
    {"type": "MSELoss", "reduction": "none"},
    {"type": "PSNRLoss"},
    {"type": "PSNRLoss", "toY": True, "loss_weight": 0.5},
])
def test_pixel_losses_match_jax(opt):
    """NCHW here, NHWC in dcpt_tpu: the same values within 1e-5 relative."""
    rng = np.random.default_rng(0)
    pred, target = rng.random((2, 3, 6, 5)).astype(np.float32), rng.random((2, 3, 6, 5)).astype(np.float32)
    ours = build_loss(opt)(torch.from_numpy(pred), torch.from_numpy(target)).numpy()
    ref = np.asarray(jax_build_loss(opt)(jnp.asarray(pred.transpose(0, 2, 3, 1)),
                                         jnp.asarray(target.transpose(0, 2, 3, 1))))
    if ours.ndim == 4:
        ours = ours.transpose(0, 2, 3, 1)
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_cross_entropy_matches_jax(reduction):
    rng = np.random.default_rng(1)
    logits, labels = rng.standard_normal((6, 5)).astype(np.float32), rng.integers(0, 5, 6)
    opt = {"type": "CrossEntropyLoss", "loss_weight": 0.7, "reduction": reduction}
    ours = build_loss(opt)(torch.from_numpy(logits), torch.from_numpy(labels)).numpy()
    ref = np.asarray(jax_build_loss(opt)(jnp.asarray(logits), jnp.asarray(labels)))
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-6)


def test_weighted_l1_mean_divides_by_the_weight_mass():
    rng = np.random.default_rng(2)
    pred, target = rng.random((2, 3, 4, 4)).astype(np.float32), rng.random((2, 3, 4, 4)).astype(np.float32)
    weight = rng.random((2, 1, 4, 4)).astype(np.float32)
    ours = build_loss({"type": "L1Loss"})(torch.from_numpy(pred), torch.from_numpy(target), torch.from_numpy(weight))
    ref = jax_build_loss({"type": "L1Loss"})(*(jnp.asarray(a.transpose(0, 2, 3, 1)) for a in (pred, target, weight)))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5)


def test_accuracy_topk_matches_jax():
    from dcpt_tpu.models.dc_util import accuracy_topk as jax_accuracy_topk
    from dcpt_tpu_torch.models.dc_util import accuracy_topk, select_taps

    rng = np.random.default_rng(4)
    logits, labels = rng.standard_normal((16, 5)).astype(np.float32), rng.integers(0, 5, 16)
    ours = accuracy_topk(torch.from_numpy(logits), torch.from_numpy(labels), topk=(1, 3))
    ref = [float(v) for v in jax_accuracy_topk(jnp.asarray(logits), jnp.asarray(labels), topk=(1, 3))]
    np.testing.assert_allclose(ours, ref, rtol=1e-6)
    taps = {"encoders.0": 0, "ups.0": 1, "decoder0.0": 2, "ups.1": 3}
    assert select_taps(taps, "ups")[::-1] == [3, 1] and select_taps(taps, None) == []
