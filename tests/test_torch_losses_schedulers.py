"""Losses, lr schedules and optimizers of the PyTorch port against dcpt_tpu's."""

import numpy as np
import optax
import pytest
import torch

import jax.numpy as jnp

from dcpt_tpu.losses import build_loss as jax_build_loss
from dcpt_tpu.models.lr_scheduler import build_schedule as jax_build_schedule
from dcpt_tpu_torch.losses import build_loss
from dcpt_tpu_torch.models.base_model import BaseModel
from dcpt_tpu_torch.models.lr_scheduler import build_schedule


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


@pytest.mark.parametrize("scheduler,warmup", [
    ({"type": "CosineAnnealingRestartLR", "periods": [10, 20, 20], "restart_weights": [1, 0.5, 0.25],
      "eta_min": 1e-7}, 5),
    ({"type": "MultiStepRestartLR", "milestones": [8, 16, 30, 40], "gamma": 0.5, "restarts": [0, 25],
      "restart_weights": [1, 0.5]}, 3),
    ({"type": "CosineAnnealingRestartLR", "periods": [50], "restart_weights": [1]}, -1),
])
def test_schedules_match_jax_over_50_iterations(scheduler, warmup):
    ours = build_schedule(dict(scheduler), 2e-4, warmup)
    ref = jax_build_schedule(dict(scheduler), 2e-4, warmup)
    np.testing.assert_allclose([ours(i) for i in range(50)], [ref(i) for i in range(50)], rtol=1e-12)


def _optimizer_parity(optim_type, optax_tx, **kwargs):
    """Three steps of the port's torch.optim optimizer against dcpt_tpu's optax
    chain times (-lr), with the lr changing per step as the schedule sets it."""
    rng = np.random.default_rng(3)
    p0 = rng.standard_normal((4, 5)).astype(np.float32)
    grads = [rng.standard_normal((4, 5)).astype(np.float32) for _ in range(3)]
    lrs = [1e-2, 5e-3, 2e-3]
    param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    model = BaseModel({"num_gpu": 0})
    model.optimizers = [model.get_optimizer(optim_type, [param], lr=lrs[0], **kwargs)]
    model.schedulers = [lambda step: lrs[step - 1]]
    jp, state = jnp.asarray(p0), optax_tx.init(jnp.asarray(p0))
    for step, g in enumerate(grads, start=1):
        model.update_learning_rate(step)
        param.grad = torch.from_numpy(g)
        model.optimizers[0].step()
        updates, state = optax_tx.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, -lrs[step - 1] * updates)
    np.testing.assert_allclose(param.detach().numpy(), np.asarray(jp), rtol=1e-5, atol=1e-7)


def test_adamw_matches_the_optax_chain():
    """AdamW (lr from the schedule, weight decay 1e-4) == chain(scale_by_adam,
    add_decayed_weights(1e-4)) x (-lr), dcpt_tpu's AdamW, for 3 steps."""
    _optimizer_parity("AdamW", optax.chain(optax.scale_by_adam(b1=0.9, b2=0.999), optax.add_decayed_weights(1e-4)),
                      weight_decay=1e-4, betas=[0.9, 0.999])


def test_adam_and_sgd_match_the_optax_chains():
    _optimizer_parity("Adam", optax.chain(optax.add_decayed_weights(1e-3), optax.scale_by_adam()), weight_decay=1e-3)
    _optimizer_parity("SGD", optax.trace(decay=0.9), momentum=0.9)


def test_unported_training_options_raise():
    for key, value in (("batched_trunk", True), ("zero_sharding", True), ("accumulate_steps", 4)):
        with pytest.raises(NotImplementedError, match=key):
            BaseModel({"num_gpu": 0, "train": {key: value}})._check_train_options()


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


def test_ema_update_matches_jax():
    from dcpt_tpu.models.base_model import BaseModel as JaxBaseModel

    rng = np.random.default_rng(5)
    ema, net = torch.nn.Linear(4, 3), torch.nn.Linear(4, 3)
    with torch.no_grad():
        for m in (ema, net):
            for p in m.parameters():
                p.copy_(torch.from_numpy(rng.standard_normal(tuple(p.shape)).astype(np.float32)))
    want = JaxBaseModel.ema_update({n: jnp.asarray(p.detach().numpy()) for n, p in ema.named_parameters()},
                                   {n: jnp.asarray(p.detach().numpy()) for n, p in net.named_parameters()}, 0.9)
    BaseModel.ema_update(ema, net, 0.9)
    for n, p in ema.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[n]), rtol=1e-6, atol=1e-7)
