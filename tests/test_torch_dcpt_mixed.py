"""The mixed-precision DCPT step (``train.mixed_precision``) of the PyTorch port
against dcpt_tpu's, on the CPU.

dcpt_tpu's recipe (its ``degradation_classification_pretrain_model.py:89-92``):
bf16 copies of every parameter of both nets and a bf16 batch, the losses on
fp32 casts, the optimizers on the fp32 masters.  A width-8 NAFNet and its
PromptIR_NoImg_DC probe start from the same weights in both packages and take
the same three batches.  Two bf16 implementations round at other places (the
port's NAFBlock twin and LayerNorm round once at their end, XLA's ops one by
one), so the bar comes from dcpt_tpu itself: the port's bf16 step may depart
import _torch_threads  # noqa: F401
from dcpt_tpu's bf16 step by at most twice as much as dcpt_tpu's bf16 step
departs from its own fp32 step on those batches (``three_mixed_steps``, which
``test_torch_dcpt_mixed_restormer.py``, ``..._promptir.py`` and
``..._swinir.py`` run on the transformer nets).  The mixed step of each
transformer net is also checked here for its fp32 masters and moments.
"""

import importlib

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
# the taps each transformer net's DCPT yml feeds its probe
HOOKS = {"Restormer": "decoder_level", "PromptIR": "decoder_level2", "SwinIR": "encode_layers"}


def _feed(model, batch):
    model.feed_data({"lq": torch.from_numpy(batch["lq"].transpose(0, 3, 1, 2).copy()),
                     "gt": torch.from_numpy(batch["gt"].transpose(0, 3, 1, 2).copy()),
                     "dataset_idx": torch.from_numpy(batch["dataset_idx"])})


def _jax_steps(jmodel, mixed, pg, pdc, archs):
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
        sd = params_to_state_dict(jax.tree_util.tree_map(np.asarray, params), archs[key])
        weights.update({f"{key}.{k}": v for k, v in sd.items()})
    return losses, weights


def _mixed_opt(tmp_path, network_g=None, network_dc=None, hook_names="ups"):
    """The tiny DCPT options with ``train.mixed_precision``: the NAFNet of
    ``test_torch_dcpt`` and its probe, or the nets given."""
    opt = _opt(tmp_path, "DCPTModel")
    if network_g is not None:
        opt.update(network_g=dict(network_g), network_dc=dict(network_dc), hook_names=hook_names)
    opt["train"]["mixed_precision"] = True
    return opt


def _mixed_model(tmp_path, pg=None, pdc=None):
    model = build_model(_mixed_opt(tmp_path))
    if pg is not None:
        model.net_g.load_state_dict(params_to_state_dict(pg, NETWORKS["g"]), strict=True)
        model.net_dc.load_state_dict(params_to_state_dict(pdc, NETWORKS["dc"]), strict=True)
    return model


def three_mixed_steps(tmp_path, network_g=None, network_dc=None, hook_names="ups", n_taps=None):
    """Three mixed-precision DCPT steps of a net and its probe in the port and in
    dcpt_tpu (in both its bf16 and its fp32 step) from the same weights on the
    same batches, held to a bar that dcpt_tpu sets itself:

    * every loss at every step: |port - dcpt_tpu bf16| / |dcpt_tpu bf16| within
      twice the largest such departure of dcpt_tpu's fp32 step from its bf16
      step over the three steps and both losses;
    * the fp32 masters after three AdamW steps (lr 1e-4): the largest element
      difference and the largest mean absolute difference of a tensor from
      dcpt_tpu's bf16 masters within twice those of dcpt_tpu's fp32 masters
      from its bf16 ones (Adam moves an element whose gradient is near zero by
      about lr of either sign, so both spreads are a few lr).  The mean leaves
      out the attention temperatures (one to eight elements a tensor): their
      gradients cancel to about 1/5.8e4 of their terms, so in bf16 both
      frameworks' readings are rounding noise (Restormer's
      ``encoder_level1`` at step 1: float64 -6.98e-4, dcpt_tpu bf16 -7.1e-5,
      the port's bf16 +4.06e-3) and Adam's update of each a coin flip of
      about lr a step; the largest difference still holds them.

    The weights start in the port (PyTorch's seeded init, the norms, residual
    scales, temperatures and mixing weights drawn at random) and reach dcpt_tpu
    through its own converter, in place of flax's eager per-parameter init.
    The probe's levels from ``n_taps`` on see no tap: dcpt_tpu creates no
    parameters for them, and they are not compared."""
    torch.manual_seed(0)
    seed_model = build_model(_mixed_opt(tmp_path / "seed", network_g, network_dc, hook_names))
    dims = seed_model.opt["network_dc"]["feature_dims"]
    unused = tuple(f"{layer}.{i}." for i in range(len(dims) if n_taps is None else n_taps, len(dims))
                   for layer in ("bottleneck_layers", "downsample_layers"))
    rng = np.random.default_rng(0)
    given, archs = {}, {}
    for key, net in (("g", seed_model.net_g), ("dc", seed_model.net_dc)):
        spec = {k: v for k, v in seed_model.opt[f"network_{key}"].items() if k != "h"}
        archs[key] = spec["type"]
        jnet = jax_build_network(spec)
        with torch.no_grad():
            for name, p in net.named_parameters():
                if name.endswith(("beta", "gamma", "temperature", "mixing_weights")) or ".norm" in name:
                    shift = 1.0 if (".norm" in name and name.endswith("weight")) or name.endswith("temperature") else 0.0
                    p.copy_(torch.from_numpy((rng.normal(0.0, 0.5, p.shape) + shift).astype(np.float32)))
        state = {k: v.numpy().copy() for k, v in net.state_dict().items() if not k.startswith(unused)}
        given[type(jnet)] = state_dict_to_params(state, key_map=type(jnet).torch_key_map)
    jopt = _mixed_opt(tmp_path / "jax", network_g, network_dc, hook_names)
    jopt["num_gpu"] = 1
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen.Module, "init", lambda self, *a, **k: {"params": given[type(self)]})
        mp.setattr(JaxDCModel, "_dummy_features", lambda self, x: None)
        jmodel = jax_build_model(jopt)
    pg, pdc = (jax.tree_util.tree_map(np.asarray, given[type(jax_build_network(
        {k: v for k, v in jopt[f"network_{key}"].items() if k != "h"}))]) for key in ("g", "dc"))
    fp32_losses, fp32_w = _jax_steps(jmodel, False, pg, pdc, archs)
    bf16_losses, bf16_w = _jax_steps(jmodel, True, pg, pdc, archs)

    model = build_model(_mixed_opt(tmp_path / "torch", network_g, network_dc, hook_names))
    model.net_g.load_state_dict(params_to_state_dict(pg, archs["g"]), strict=True)
    model.net_dc.load_state_dict(params_to_state_dict(pdc, archs["dc"]), strict=not unused)
    port_losses = []
    for it, batch in enumerate(_batches(), start=1):
        model.update_learning_rate(it)
        _feed(model, batch)
        model.optimize_parameters(it)
        port_losses.append(dict(model.log_dict))
    port_w = {f"{key}.{k}": v for key, net in (("g", model.net_g), ("dc", model.net_dc))
              for k, v in net.state_dict().items() if not (key == "dc" and k.startswith(unused))}

    def rel(a, b):
        return max(abs(x[k] - y[k]) / abs(y[k]) for x, y in zip(a, b) for k in y)

    spread = rel(fp32_losses, bf16_losses)
    assert 0 < spread < 1e-1 and rel(port_losses, bf16_losses) <= 2 * spread, (port_losses, bf16_losses, spread)
    assert set(port_w) == set(bf16_w)
    meaned = [k for k in bf16_w if not k.endswith("temperature")]
    for stat, keys in ((lambda d: d.abs().max().item(), list(bf16_w)), (lambda d: d.abs().mean().item(), meaned)):
        jax_spread = max(stat(fp32_w[k] - bf16_w[k]) for k in keys)
        port = max(stat(port_w[k] - bf16_w[k]) for k in keys)
        assert 0 < jax_spread and port <= 2 * jax_spread, (port, jax_spread)


def test_three_mixed_steps_match_dcpt_tpu(tmp_path):
    """A width-8 NAFNet and its PromptIR_NoImg_DC probe (``three_mixed_steps``)."""
    three_mixed_steps(tmp_path)


@pytest.mark.parametrize("net", ["NAFNet", "Restormer", "PromptIR", "SwinIR"])
def test_mixed_masters_and_moments_stay_fp32(tmp_path, net):
    """The model builds for each net with ``train.mixed_precision`` and takes a
    step (the tiny nets of the three-step tests, Restormer in the shipped ReLU
    flavour): every module output of the step is bf16, the losses are finite,
    every parameter of the restoration net has a gradient (and of NAFNet's
    probe; the transformer nets' probe levels that no tap feeds have none),
    and the parameters, their gradients and AdamW's moments are fp32."""
    if net == "NAFNet":
        opt = _mixed_opt(tmp_path)
    else:
        module = importlib.import_module(f"test_torch_dcpt_{net.lower()}")
        network_g = {k: v for k, v in module.NETWORK_G.items() if k != "use_softmax"}
        opt = _mixed_opt(tmp_path, network_g, module.NETWORK_DC, HOOKS[net])
    model = build_model(opt)
    _feed(model, _batches(1)[0])
    seen = set()
    hook = torch.nn.modules.module.register_module_forward_hook(
        lambda mod, args, out: seen.add(out.dtype) if isinstance(out, torch.Tensor) else None)
    try:
        model.optimize_parameters(1)
    finally:
        hook.remove()
    assert seen == {torch.bfloat16}
    assert set(model.log_dict) == {"l_pix", "l_classify"} and all(np.isfinite(v) for v in model.log_dict.values())
    assert all(p.grad is not None for p in model.net_g.parameters())
    if net == "NAFNet":  # its probe's four levels all take a tap
        assert all(p.grad is not None for p in model.net_dc.parameters())
    for net_ in (model.net_g, model.net_dc):
        params = list(net_.parameters())
        assert all(p.dtype == torch.float32 for p in params)
        assert all(p.grad.dtype == torch.float32 for p in params if p.grad is not None)
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
