"""The mixed-precision DCPT step (``train.mixed_precision``) of the PyTorch port
against dcpt_tpu's, on the CPU.

dcpt_tpu's recipe (its ``degradation_classification_pretrain_model.py:89-92``):
bf16 copies of every parameter of both nets and a bf16 batch, the losses on
fp32 casts, the optimizers on the fp32 masters.  A width-8 NAFNet and its
PromptIR_NoImg_DC probe start from the same weights in both packages and take
the same three batches.  Two bf16 implementations round at other places (the
port's NAFBlock twin and LayerNorm round once at their end, XLA's ops one by
one), so the bar comes from dcpt_tpu itself: the port's bf16 step may depart
from dcpt_tpu's bf16 step by at most twice as much as dcpt_tpu's bf16 step
departs from its own fp32 step on those batches.
"""

import numpy as np
import pytest
import torch

import jax

import flax.linen

from dcpt_tpu.archs import build_network as jax_build_network
from dcpt_tpu.convert.torch_checkpoint import state_dict_to_params
from dcpt_tpu.models import build_model as jax_build_model
from dcpt_tpu.models.degradation_classification_model import DCModel as JaxDCModel
from dcpt_tpu_torch.convert.jax_params import params_to_state_dict
from dcpt_tpu_torch.models import build_model
from test_torch_dcpt import _batches, _opt

NETWORKS = {"g": "NAFNetBaseline", "dc": "PromptIR_NoImg_DC"}


def _feed(model, batch):
    model.feed_data({"lq": torch.from_numpy(batch["lq"].transpose(0, 3, 1, 2).copy()),
                     "gt": torch.from_numpy(batch["gt"].transpose(0, 3, 1, 2).copy()),
                     "dataset_idx": torch.from_numpy(batch["dataset_idx"])})


def _jax_steps(jmodel, mixed, pg, pdc):
    """Three steps of dcpt_tpu's model from (pg, pdc) with fresh optimizer states;
    returns the losses of each step and both nets' weights as state dicts."""
    jmodel.opt["train"]["mixed_precision"] = mixed
    jmodel._train_step = jmodel._make_train_step()
    jmodel.params_g = jax.tree_util.tree_map(jax.numpy.asarray, pg)
    jmodel.params_dc = jax.tree_util.tree_map(jax.numpy.asarray, pdc)
    jmodel.opt_state_g = jmodel.optimizer_g.init(jmodel.params_g)
    jmodel.opt_state_dc = jmodel.optimizer_dc.init(jmodel.params_dc)
    losses = []
    for it, batch in enumerate(_batches(), start=1):
        jmodel.update_learning_rate(it)
        jmodel.feed_data(batch)
        jmodel.optimize_parameters(it)
        losses.append(dict(jmodel.log_dict))
    weights = {}
    for key, params in (("g", jmodel.params_g), ("dc", jmodel.params_dc)):
        sd = params_to_state_dict(jax.tree_util.tree_map(np.asarray, params), NETWORKS[key])
        weights.update({f"{key}.{k}": v for k, v in sd.items()})
    return losses, weights


def _mixed_model(tmp_path, pg=None, pdc=None):
    opt = _opt(tmp_path, "DCPTModel")
    opt["train"]["mixed_precision"] = True
    model = build_model(opt)
    if pg is not None:
        model.net_g.load_state_dict(params_to_state_dict(pg, NETWORKS["g"]), strict=True)
        model.net_dc.load_state_dict(params_to_state_dict(pdc, NETWORKS["dc"]), strict=True)
    return model


def test_three_mixed_steps_match_dcpt_tpu(tmp_path):
    """Every loss at every step: |port - dcpt_tpu bf16| / |dcpt_tpu bf16| within twice
    the largest such departure of dcpt_tpu's fp32 step from its bf16 step over the
    three steps and both losses.  The fp32 masters after three AdamW steps (lr 1e-4):
    the largest element difference and the mean absolute difference from dcpt_tpu's
    bf16 masters within twice those of dcpt_tpu's fp32 masters from its bf16 ones
    (Adam moves an element whose gradient is near zero by about lr of either sign,
    so both spreads are a few lr)."""
    # the weights start in the port (PyTorch's seeded init, the norms, residual scales and
    # mixing weights drawn at random) and reach dcpt_tpu through its own converter, in
    # place of flax's eager per-parameter init (half a minute on the CPU)
    torch.manual_seed(0)
    seed_model = _mixed_model(tmp_path / "seed")
    rng = np.random.default_rng(0)
    given = {}
    for key, net in (("g", seed_model.net_g), ("dc", seed_model.net_dc)):
        jnet = jax_build_network(seed_model.opt[f"network_{key}"])
        with torch.no_grad():
            for name, p in net.named_parameters():
                if name.endswith(("beta", "gamma", "mixing_weights")) or ".norm" in name:
                    shift = 1.0 if ".norm" in name and name.endswith("weight") else 0.0
                    p.copy_(torch.from_numpy((rng.normal(0.0, 0.5, p.shape) + shift).astype(np.float32)))
        state = {k: v.numpy().copy() for k, v in net.state_dict().items()}
        given[type(jnet)] = state_dict_to_params(state, key_map=type(jnet).torch_key_map)
    jopt = _opt(tmp_path / "jax", "DCPTModel")
    jopt["num_gpu"] = 1
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen.Module, "init", lambda self, *a, **k: {"params": given[type(self)]})
        mp.setattr(JaxDCModel, "_dummy_features", lambda self, x: None)
        jmodel = jax_build_model(jopt)
    pg, pdc = (jax.tree_util.tree_map(np.asarray, given[type(jax_build_network(jopt[f"network_{key}"]))])
               for key in ("g", "dc"))
    fp32_losses, fp32_w = _jax_steps(jmodel, False, pg, pdc)
    bf16_losses, bf16_w = _jax_steps(jmodel, True, pg, pdc)

    model = _mixed_model(tmp_path / "torch", pg, pdc)
    port_losses = []
    for it, batch in enumerate(_batches(), start=1):
        model.update_learning_rate(it)
        _feed(model, batch)
        model.optimize_parameters(it)
        port_losses.append(dict(model.log_dict))
    port_w = {f"{key}.{k}": v for key, net in (("g", model.net_g), ("dc", model.net_dc))
              for k, v in net.state_dict().items()}

    def rel(a, b):
        return max(abs(x[k] - y[k]) / abs(y[k]) for x, y in zip(a, b) for k in y)

    spread = rel(fp32_losses, bf16_losses)
    assert 0 < spread < 1e-1 and rel(port_losses, bf16_losses) <= 2 * spread, (port_losses, bf16_losses, spread)
    assert set(port_w) == set(bf16_w)
    for stat in (lambda d: d.abs().max().item(), lambda d: d.abs().mean().item()):
        jax_spread = max(stat(fp32_w[k] - bf16_w[k]) for k in bf16_w)
        port = max(stat(port_w[k] - bf16_w[k]) for k in bf16_w)
        assert 0 < jax_spread and port <= 2 * jax_spread, (port, jax_spread)


def test_mixed_masters_and_moments_stay_fp32(tmp_path):
    """The parameters, their gradients and AdamW's moments are fp32 after a mixed
    step; the nets' forwards ran in bf16 (the step's cast copies)."""
    model = _mixed_model(tmp_path)
    _feed(model, _batches(1)[0])
    seen = set()
    hook = torch.nn.modules.module.register_module_forward_hook(
        lambda mod, args, out: seen.add(out.dtype) if isinstance(out, torch.Tensor) else None)
    try:
        model.optimize_parameters(1)
    finally:
        hook.remove()
    assert seen == {torch.bfloat16}
    for net in (model.net_g, model.net_dc):
        assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32 for p in net.parameters())
    for optimizer in model.optimizers:
        states = list(optimizer.state.values())
        assert states and all(s["exp_avg"].dtype == s["exp_avg_sq"].dtype == torch.float32 for s in states)


def test_mixed_save_and_resume(tmp_path):
    """Two mixed steps, a save, a fresh model loading the saved nets and state, and
    a third step: the same fp32 masters and moments, bit for bit, as three steps
    without the round trip."""
    batches = _batches()
    run = _mixed_model(tmp_path / "run")
    torch.manual_seed(0)
    first = _mixed_model(tmp_path / "first")
    first.net_g.load_state_dict(run.net_g.state_dict())
    first.net_dc.load_state_dict(run.net_dc.state_dict())
    for it, batch in enumerate(batches[:2], start=1):
        for model in (run, first):
            model.update_learning_rate(it)
            _feed(model, batch)
            model.optimize_parameters(it)
    models = tmp_path / "first" / "models"
    models.mkdir(parents=True)
    first.save(0, 2)
    resumed = _mixed_model(tmp_path / "resumed")
    resumed.load_network(resumed.net_g, str(models / "net_g_2.pth"))
    resumed.load_network(resumed.net_dc, str(models / "net_dc_2.pth"))
    resumed.resume_training(torch.load(tmp_path / "first" / "states" / "2.state", weights_only=True))
    for model in (run, resumed):
        model.update_learning_rate(3)
        _feed(model, batches[2])
        model.optimize_parameters(3)
    for a, b in ((run.net_g, resumed.net_g), (run.net_dc, resumed.net_dc)):
        for (name, p), q in zip(a.named_parameters(), b.parameters()):
            assert q.dtype == torch.float32 and torch.equal(p, q), name
    for oa, ob in zip(run.optimizers, resumed.optimizers):
        for sa, sb in zip(oa.state.values(), ob.state.values()):
            assert sb["exp_avg"].dtype == torch.float32 and torch.equal(sa["exp_avg"], sb["exp_avg"])
            assert torch.equal(sa["exp_avg_sq"], sb["exp_avg_sq"])


@pytest.mark.parametrize("network_g", [
    {"type": "Restormer", "dim": 8, "num_blocks": [1, 1, 1, 1], "num_refinement_blocks": 1, "window_size": 8},
    {"type": "SwinIR", "embed_dim": 12, "depths": [2, 2], "num_heads": [2, 2], "window_size": 8, "mlp_ratio": 2.0,
     "upscale": 1},
], ids=["Restormer", "SwinIR"])
def test_mixed_precision_raises_for_transformer_nets(tmp_path, network_g):
    """Their blocks' backward kernels (K7, K9) take fp32 only: the model raises when
    it is built, before any step, and names the ROADMAP item."""
    opt = _opt(tmp_path, "DCPTModel")
    opt["network_g"] = network_g
    opt["network_dc"] = {"type": "PromptIR_NoImg_DC", "feature_dims": [16], "num_res_blocks": 1, "num_classes": 5}
    opt["train"]["mixed_precision"] = True
    with pytest.raises(NotImplementedError, match=r"ROADMAP Q1 #2"):
        build_model(opt)
