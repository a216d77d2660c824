"""The port's training-state plumbing against dcpt_tpu's, on the CPU: the
optimizer zoo (three steps of each of the seven types against dcpt_tpu's optax
chain), ``train.grad_clip`` per optimizer, and ``logger.keep_checkpoints``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _torch_threads  # noqa: F401
from dcpt_tpu.models.base_model import BaseModel as JaxBaseModel
from dcpt_tpu_torch.models import build_model
from dcpt_tpu_torch.models.base_model import BaseModel
from dcpt_tpu_torch.train import load_resume_state
from test_torch_dcpt import _opt

SHAPES = {"w": (5, 7), "b": (7,)}
OPTIMIZERS = {
    "Adam": {"weight_decay": 1e-2, "betas": [0.9, 0.99]},
    "AdamW": {"weight_decay": 1e-2, "betas": [0.9, 0.999]},
    "Adamax": {"betas": [0.9, 0.999]},
    "SGD": {"momentum": 0.9, "weight_decay": 1e-3},
    "ASGD": {"momentum": 0.9, "weight_decay": 1e-2},  # dcpt_tpu ignores both
    "RMSprop": {"alpha": 0.9, "eps": 1e-3},
    "Rprop": {},
}


def _bare(cls, opt):
    model = cls.__new__(cls)
    model.opt = opt
    return model


@pytest.mark.parametrize("optim_type", list(OPTIMIZERS))
def test_optimizer_steps_as_dcpt_tpu(optim_type):
    """Three steps at lr 1e-2 on seeded gradients, each step's lr different (a
    schedule's), from the same parameters: within 1e-6 of dcpt_tpu's
    ``get_optimizer`` transform times -lr.  ASGD is plain SGD there.  RMSprop's eps (1e-3) is large
    enough that inside or outside the root parts by 1e-2; Rprop's gradients
    flip sign on some elements at steps 2 and 3."""
    rng = np.random.default_rng(3)
    start = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()} for _ in range(3)]
    lrs = [1e-2, 8e-3, 5e-3]
    kwargs = OPTIMIZERS[optim_type]

    tx = JaxBaseModel.get_optimizer(_bare(JaxBaseModel, {}), optim_type, lr=lrs[0], **kwargs)
    params = jax.tree_util.tree_map(jnp.asarray, start)
    state = tx.init(params)
    for g, lr in zip(grads, lrs):
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, params)
        params = jax.tree_util.tree_map(lambda p, u: p - lr * u, params, updates)

    tensors = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in start.items()}
    optimizer = BaseModel.get_optimizer(_bare(BaseModel, {}), optim_type, tensors.values(), lr=lrs[0], **kwargs)
    for g, lr in zip(grads, lrs):
        for k, p in tensors.items():
            p.grad = torch.from_numpy(g[k])
        for group in optimizer.param_groups:
            group["lr"] = lr
        optimizer.step()
    for k, p in tensors.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[k]), rtol=0, atol=1e-6, err_msg=k)


def _clip_model(tmp_path, clip):
    opt = _opt(tmp_path, "DCPTModel")
    opt["train"]["grad_clip"] = clip
    for key in ("optim_g", "optim_dc"):
        opt["train"][key] = {"type": "SGD", "lr": 1.0}
    return build_model(opt)


def _set_grads(model, rng):
    """net_g's gradients large (global norm far above 1), net_dc's small (below 1)."""
    for net, scale in ((model.net_g, 3.0), (model.net_dc, 1e-3)):
        for p in net.parameters():
            p.grad = torch.from_numpy((rng.standard_normal(p.shape) * scale).astype(np.float32))


@pytest.mark.parametrize("via", ["clip_gradients", "optimize_parameters"])
def test_grad_clip_per_optimizer(tmp_path, via):
    """``train.grad_clip`` 1.0 on a DCPTModel whose net_g gradients have a global
    norm far above 1 and net_dc's one below it: each net's gradients as
    dcpt_tpu's ``chain(clip_by_global_norm(1.0), identity)`` leaves them, so
    net_dc's stay as they were (a joint norm would scale them down too).
    Through ``optimize_parameters`` with SGD at lr 1, each parameter moves by
    its clipped gradient."""
    model = _clip_model(tmp_path, 1.0)
    rng = np.random.default_rng(4)
    _set_grads(model, rng)
    nets = {"net_g": model.net_g, "net_dc": model.net_dc}
    raw = {k: [p.grad.clone() for p in net.parameters()] for k, net in nets.items()}
    before = {k: [p.detach().clone() for p in net.parameters()] for k, net in nets.items()}
    if via == "clip_gradients":
        model.clip_gradients()
        moved = {k: [p.grad for p in net.parameters()] for k, net in nets.items()}
    else:
        model.compute_gradients = lambda: {}
        model.optimize_parameters(1)
        moved = {k: [b - p.detach() for b, p in zip(before[k], net.parameters())] for k, net in nets.items()}
    tx = JaxBaseModel.get_optimizer(_bare(JaxBaseModel, {"train": {"grad_clip": 1.0}}), "SGD", lr=1.0)
    for k in nets:
        grads = [jnp.asarray(g.numpy()) for g in raw[k]]
        want, _ = tx.update(grads, tx.init(grads))
        for got, w in zip(moved[k], want):
            np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-5, atol=1e-7, err_msg=k)
    norm = lambda gs: float(torch.sqrt(sum((g.double() ** 2).sum() for g in gs)))  # noqa: E731
    assert norm(raw["net_g"]) > 10 and norm(moved["net_g"]) == pytest.approx(1.0, rel=1e-5)
    assert norm(raw["net_dc"]) < 1
    # untouched: bit for bit after the clip; within the rounding of p - (p - g) for parameters below 4 after the step
    atol = 0.0 if via == "clip_gradients" else 4 * 2.0 ** -23
    for got, r in zip(moved["net_dc"], raw["net_dc"]):
        torch.testing.assert_close(got, r, rtol=0, atol=atol)


def test_keep_checkpoints_prunes_and_resumes(tmp_path):
    """``logger.keep_checkpoints`` 2 and five saves: the two newest training states
    stay, and ``--auto_resume`` picks the newest and restores its optimizers."""
    opt = _opt(tmp_path, "DCPTModel")
    opt["logger"] = {"keep_checkpoints": 2}
    model = build_model(opt)
    rng = np.random.default_rng(5)
    for it in range(1, 6):
        _set_grads(model, rng)
        for optimizer in model.optimizers:
            optimizer.step()
        model.save_training_state(epoch=0, current_iter=it * 10)
    states = sorted(p.name for p in (tmp_path / "states").iterdir())
    assert states == ["40.state", "50.state"]

    opt["auto_resume"] = True
    path = load_resume_state(opt)
    assert path.endswith("50.state")
    resumed = build_model(_opt(tmp_path / "fresh", "DCPTModel"))
    state = torch.load(path, map_location="cpu", weights_only=True)
    assert state["iter"] == 50
    resumed.resume_training(state)
    for a, b in zip(resumed.optimizers, model.optimizers):
        sa, sb = a.state_dict()["state"], b.state_dict()["state"]
        assert sa.keys() == sb.keys() and sa[0]["step"].item() == 5
        for i in sb:
            torch.testing.assert_close(sa[i]["exp_avg"], sb[i]["exp_avg"], rtol=0, atol=0)
