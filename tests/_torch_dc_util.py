"""Helpers of the port's tests of DCPT's probe and fine-tune stages and of the
training loop (``test_torch_dc_probe.py``, ``test_torch_dcdist.py``,
``test_torch_train_loop.py``): a tiny NAFNet and its probe, the options of each
training model, one set of weights in both packages, seeded batches, and
dcpt_tpu's steps from those weights.

The weights start in the port (PyTorch's seeded init, with the residual scales,
LayerNorm affines and mixing weights drawn at random: at init every NAFBlock is
the identity) and reach dcpt_tpu through its own converter
(``state_dict_to_params`` with each arch's ``torch_key_map``), handed to its
model in place of flax's eager per-parameter init."""

import numpy as np
import pytest
import torch

import jax

NETWORK_G = {"type": "NAFNetBaseline", "width": 8, "enc_blk_nums": [1, 1], "middle_blk_num": 1,
             "dec_blk_nums": [1, 1], "window_size": 4, "h": 16}
NETWORK_DC = {"type": "PromptIR_NoImg_DC", "feature_dims": [8, 16], "num_res_blocks": 1, "num_classes": 5}
ARCHS = {"g": "NAFNetBaseline", "dc": "PromptIR_NoImg_DC"}
ADAMW = {"type": "AdamW", "lr": 1e-4, "weight_decay": 1e-4, "betas": [0.9, 0.999]}
# the net each model trains, and its attribute names in dcpt_tpu's model
TRAINED = {"DCModel": ("dc", "params_dc", "opt_state_dc", "optimizer_dc", "params_dc_ema"),
           "DCDistModel": ("g", "params_g", "opt_state_g", "optimizer_g", "params_g_ema"),
           "SRModel": ("g", "params_g", "opt_state_g", "optimizer_g", "params_g_ema"),
           "DCPTModel": ("g", "params_g", "opt_state_g", "optimizer_g", None)}


def options(root, model_type, **train):
    """The tiny options of ``model_type`` on the CPU; ``train`` entries override."""
    train_opt = {"scheduler": {"type": "CosineAnnealingRestartLR", "periods": [10], "restart_weights": [1],
                               "eta_min": 1e-7},
                 "total_iter": 3, "ema_decay": 0.9}
    if model_type == "DCModel":
        train_opt.update(optim_dc=dict(ADAMW), classify_opt={"type": "CrossEntropyLoss"})
    elif model_type == "DCPTModel":
        train_opt.update(optim_g=dict(ADAMW), optim_dc=dict(ADAMW), pixel_opt={"type": "L1Loss"},
                         classify_opt={"type": "CrossEntropyLoss"})
        del train_opt["ema_decay"]
    else:
        train_opt.update(optim_g=dict(ADAMW), pixel_opt={"type": "L1Loss", "loss_weight": 1.0})
        if model_type == "DCDistModel":
            train_opt["classify_opt"] = {"type": "CrossEntropyLoss", "loss_weight": 0.1}
    train_opt.update(train)
    return {"name": f"tiny_{model_type}", "model_type": model_type, "scale": 1, "num_gpu": 0, "manual_seed": 0,
            "is_train": True, "dist": False, "rank": 0, "world_size": 1, "hook_names": "ups",
            "network_g": dict(NETWORK_G), "network_dc": dict(NETWORK_DC),
            "path": {"models": str(root / "models"), "training_states": str(root / "states"),
                     "visualization": str(root / "vis"), "log": str(root)},
            "train": train_opt,
            "val": {"metrics": {"psnr": {"type": "calculate_psnr", "crop_border": 0, "image_range": 255.0},
                                "ssim": {"type": "calculate_ssim", "crop_border": 0, "image_range": 255.0}}}}


def seeded_weights(seed=0):
    """Both nets' weights as port state dicts (numpy copies)."""
    from dcpt_tpu_torch.archs import build_network

    torch.manual_seed(seed)
    rng = np.random.default_rng(seed)
    out = {}
    for key, spec in (("g", NETWORK_G), ("dc", NETWORK_DC)):
        net = build_network({k: v for k, v in spec.items() if k != "h"})
        with torch.no_grad():
            for name, p in net.named_parameters():
                if name.endswith(("beta", "gamma", "mixing_weights")) or "norm" in name:
                    shift = 1.0 if "norm" in name and name.endswith("weight") else 0.0
                    p.copy_(torch.from_numpy((rng.normal(0.0, 0.5, p.shape) + shift).astype(np.float32)))
        out[key] = {k: v.numpy().copy() for k, v in net.state_dict().items()}
    return out


def jax_model(opt, weights):
    """dcpt_tpu's model of ``opt`` (``num_gpu`` 1: its CPU device) on ``weights``."""
    import flax.linen

    from dcpt_tpu.archs import build_network as jax_build_network
    from dcpt_tpu.convert.torch_checkpoint import state_dict_to_params
    from dcpt_tpu.models import build_model as jax_build_model
    from dcpt_tpu.models.degradation_classification_model import DCModel as JaxDCModel

    given = {}
    for key, spec in (("g", NETWORK_G), ("dc", NETWORK_DC)):
        cls = type(jax_build_network({k: v for k, v in spec.items() if k != "h"}))
        given[cls] = state_dict_to_params({k: v.copy() for k, v in weights[key].items()}, key_map=cls.torch_key_map)
    opt = dict(opt, num_gpu=1)
    real_apply = flax.linen.Module.apply

    def jitted_apply(self, variables, *args, **kwargs):  # one compile, not one an op, for the model's shape pass
        return jax.jit(lambda v, *a: real_apply(self, v, *a, **kwargs))(variables, *args)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen.Module, "init",
                   lambda self, *a, **k: {"params": jax.tree_util.tree_map(jax.numpy.asarray, given[type(self)])})
        mp.setattr(flax.linen.Module, "apply", jitted_apply)
        mp.setattr(JaxDCModel, "_dummy_features", lambda self, x: None)
        return jax_build_model(opt)


def port_model(opt, weights):
    """The port's model of ``opt`` on ``weights``."""
    from dcpt_tpu_torch.models import build_model

    model = build_model(opt)
    for key in ("g", "dc"):
        net = getattr(model, f"net_{key}", None)
        if net is not None:
            net.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in weights[key].items()})
    for key in ("g", "dc"):  # the EMA copies taken at init follow the weights just loaded
        ema = getattr(model, f"net_{key}_ema", None)
        if ema is not None:
            ema.load_state_dict(getattr(model, f"net_{key}").state_dict())
    return model


def batches(n=3, b=2, hw=16, seed=11):
    """Seeded NHWC numpy batches with labels in 0..4."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        gt = rng.random((b, hw, hw, 3)).astype(np.float32)
        lq = np.clip(gt * 0.8 + rng.normal(0, 0.05, gt.shape), 0, 1).astype(np.float32)
        out.append({"lq": lq, "gt": gt, "dataset_idx": rng.integers(0, 5, b), "lq_path": [f"{i}.png" for i in range(b)]})
    return out


def to_torch(batch):
    """An NHWC numpy batch as the port's loader gives it: NCHW tensors."""
    out = {}
    for k, v in batch.items():
        if k in ("lq", "gt"):
            out[k] = torch.from_numpy(v.transpose(0, 3, 1, 2).copy())
        elif k == "dataset_idx":
            out[k] = torch.from_numpy(np.asarray(v))
        else:
            out[k] = v
    return out


def jax_state(jmodel, model_type, params=None):
    """dcpt_tpu's trained net (or ``params``) as a port state dict."""
    key, attr = TRAINED[model_type][:2]
    from dcpt_tpu_torch.convert.jax_params import params_to_state_dict

    tree = getattr(jmodel, attr) if params is None else params
    return params_to_state_dict(jax.tree_util.tree_map(np.asarray, tree), ARCHS[key])


def jax_tree(jmodel, key, state):
    """A port state dict of net ``key`` as dcpt_tpu's params tree (its converter)."""
    from dcpt_tpu.convert.torch_checkpoint import state_dict_to_params

    cls = type(getattr(jmodel, f"net_{key}"))
    return jax.tree_util.tree_map(jax.numpy.asarray, state_dict_to_params(
        {k: np.array(v) for k, v in state.items()}, key_map=cls.torch_key_map))


def jax_steps(jmodel, model_type, weights, data, mixed=False):
    """dcpt_tpu's steps on ``data`` from ``weights`` with a fresh optimizer
    state (and EMA): the losses of each step, the trained net and its EMA as
    port state dicts."""
    key, attr, state_attr, optim_attr, ema_attr = TRAINED[model_type]
    steps = jmodel.__dict__.setdefault("_steps_by_precision", {})  # one jit (and compile) a precision
    if mixed not in steps:
        jmodel.opt["train"]["mixed_precision"] = mixed
        steps[mixed] = jmodel._make_train_step()
    jmodel._train_step = steps[mixed]
    params = jax_tree(jmodel, key, weights[key])
    setattr(jmodel, attr, params)
    setattr(jmodel, state_attr, getattr(jmodel, optim_attr).init(params))
    if ema_attr is not None and getattr(jmodel, ema_attr) is not None:
        setattr(jmodel, ema_attr, jax.tree_util.tree_map(jax.numpy.copy, params))
    losses = []
    for it, batch in enumerate(data, start=1):
        jmodel.update_learning_rate(it)
        jmodel.feed_data({k: v for k, v in batch.items() if k != "lq_path"})
        jmodel.optimize_parameters(it)
        losses.append(dict(jmodel.log_dict))
    ema = getattr(jmodel, ema_attr) if ema_attr is not None else None
    return losses, jax_state(jmodel, model_type), None if ema is None else jax_state(jmodel, model_type, ema)


def port_steps(model, data):
    losses = []
    for it, batch in enumerate(data, start=1):
        model.update_learning_rate(it)
        model.feed_data(to_torch(batch))
        model.optimize_parameters(it)
        losses.append(dict(model.log_dict))
    return losses


def assert_states_close(got, want, rtol=1e-4, atol=1e-5):
    """The bar of ``test_torch_dcpt.py``: rtol 1e-4, atol 1e-5 (a tenth of one AdamW step at lr 1e-4)."""
    assert set(got) == set(want)
    for name, value in want.items():
        np.testing.assert_allclose(got[name].detach().numpy(), np.asarray(value), rtol=rtol, atol=atol, err_msg=name)


def mixed_bar(port_losses, port_w, jax_bf16, jax_fp32):
    """The bar of ``test_torch_dcpt_mixed.py::three_mixed_steps``: the port's bf16
    run may depart from dcpt_tpu's bf16 run by at most twice as much as
    dcpt_tpu's fp32 run departs from its bf16 run, in every loss and in the
    largest element and the largest mean absolute difference of a tensor."""
    (bf16_losses, bf16_w), (fp32_losses, fp32_w) = jax_bf16, jax_fp32

    def rel(a, b):
        return max(abs(x[k] - y[k]) / abs(y[k]) for x, y in zip(a, b) for k in y)

    spread = rel(fp32_losses, bf16_losses)
    assert 0 < spread < 1e-1 and rel(port_losses, bf16_losses) <= 2 * spread, (port_losses, bf16_losses, spread)
    assert set(port_w) == set(bf16_w)
    for stat in (lambda d: np.abs(d).max(), lambda d: np.abs(d).mean()):
        jax_spread = max(stat(np.asarray(fp32_w[k]) - np.asarray(bf16_w[k])) for k in bf16_w)
        port = max(stat(port_w[k].detach().numpy() - np.asarray(bf16_w[k])) for k in bf16_w)
        assert 0 < jax_spread and port <= 2 * jax_spread, (port, jax_spread)


class Loader(list):
    """Batches with a ``dataset.opt["name"]``, as a validation loader has."""

    def __init__(self, items, name="val"):
        super().__init__(items)
        self.dataset = type("Dataset", (), {"opt": {"name": name}})()
