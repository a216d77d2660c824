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

import _torch_threads  # noqa: F401
from _torch_threads import default_threads  # noqa: F401  (a fixture)
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
def test_three_steps_match_dcpt_tpu(tmp_path, model_type, default_threads):
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


def _randomize_torch(net, rng):
    """The LayerNorm affines, temperatures and mixing weights drawn at random, in place."""
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith(("temperature", "mixing_weights")) or ".norm" in name:
                shift = 1.0 if name.endswith(("weight", "temperature")) else 0.0
                p.copy_(torch.from_numpy((rng.normal(0.0, 0.5, p.shape) + shift).astype(np.float32)))


class _Override:
    """A module seen with some of its attributes replaced; the others read through."""

    def __init__(self, module, **replaced):
        self._module, self._replaced = module, replaced

    def __getattr__(self, name):
        return self._replaced[name] if name in self._replaced else getattr(self._module, name)


def _smooth_probe(mp, net_dc):
    """The probe's ReLUs as SiLUs and its max-pools as average pools, in both
    frameworks (dcpt_tpu's through the names its module looks up at call time)."""
    import flax.linen
    from torch import nn

    import dcpt_tpu.archs.degrad_classify_arch as jax_dc
    import dcpt_tpu_torch.archs.degrad_classify_arch as torch_dc

    mp.setattr(jax_dc, "nn", _Override(flax.linen, relu=jax.nn.silu, max_pool=flax.linen.avg_pool))
    mp.setattr(torch_dc, "F", _Override(torch.nn.functional, relu=torch.nn.functional.silu))
    for down in net_dc.downsample_layers:
        down[1], down[2] = nn.AvgPool2d(2), nn.SiLU()


def _adam_moments(opt_state):
    """(mu, nu) of the scale_by_adam state inside an optax chain's state."""
    state = next(s for s in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda s: hasattr(s, "mu"))
                 if hasattr(s, "mu"))
    return state.mu, state.nu


def three_transformer_steps(tmp_path, network_g, network_dc, hook_names, n_taps, exact_zero=None):
    """Three DCPTModel steps of a transformer net (Restormer or PromptIR) and the
    probe in the port and in dcpt_tpu on the same batches, each step from the
    same weights (the port takes dcpt_tpu's before steps 2 and 3; each
    framework keeps its own Adam moments).  At every step:

    * the losses within rtol 1e-4;
    * every parameter's gradient (dcpt_tpu's read from its Adam first moment)
      within 1e-4 of the tensor's max|g| plus 1e-6 of the step's largest
      max|g|: a sum's rounding scales with its terms, not with the sum, and a
      temperature's gradient cancels (PromptIR seed 1's
      ``encoder_level1.0.attn.temperature`` at step 2: max|g| 2.1e-5, the
      frameworks 2.2e-9 apart);
    * the parameters after the update within rtol 1e-4 / atol 1e-5 wherever
      Adam's denominator sqrt(v_hat) is at least 100 times the element's
      measured gradient difference dg.  The update lr m_hat / (sqrt(v_hat) +
      eps) moves by about 2 lr |dg| / sqrt(v_hat), so an element whose gradient
      is within float noise of zero (at step 1 sqrt(v_hat) = |g|) takes an
      update of either sign; the rule leaves out at most a thousandth of the
      elements.

    Why each step starts from the same weights, and why the probe's ReLUs and
    max-pools run as SiLUs and average pools in both frameworks: run freely,
    such an element ends step 1 a full 2 lr apart, and from step 2 on the
    gradients of whole tensors part by up to 1e-2 of their max (Restormer seed
    0); even from the same weights fp32 rounding flips a switch now and then
    (Restormer seed 6, step 2: 2.4e-2 of ``decoder_level1``'s qkv weight).
    With both measures every seed tried, 0 to 11 of each net, passes; the
    test runs seed 0.

    The weights start in the port (PyTorch's seeded init, with the norms,
    temperatures and mixing weights randomised) and reach dcpt_tpu through its
    own converter (``state_dict_to_params`` with each arch's
    ``torch_key_map``), handed to its model in place of flax's eager
    per-parameter init, which at these nets' hundreds of parameters takes over
    a minute on the CPU.  The probe's levels from ``n_taps`` on see no tap:
    dcpt_tpu creates no parameters for them, and the port leaves them
    untouched (their gradients are None).

    ``exact_zero(name)``, where given, picks the elements of a parameter whose
    gradient is zero in exact arithmetic (SwinIR's key bias: the softmax of a
    row ignores a shift of all its logits).  There both frameworks' gradients
    must be float noise, below 1e-6 of the step's largest, and the update
    (Adam's step is the sign of that noise) is neither compared nor counted."""
    import flax.linen

    from dcpt_tpu.archs import build_network as jax_build_network
    from dcpt_tpu.convert.torch_checkpoint import state_dict_to_params
    from dcpt_tpu.models.degradation_classification_model import DCModel as JaxDCModel

    def opt(root):
        o = _opt(root, "DCPTModel")
        o.update(network_g=dict(network_g), network_dc=dict(network_dc), hook_names=hook_names)
        return o

    torch.manual_seed(0)  # the weights _randomize_torch leaves at PyTorch's init
    model = build_model(opt(tmp_path / "torch"))
    rng = np.random.default_rng(0)
    _randomize_torch(model.net_g, rng)
    _randomize_torch(model.net_dc, rng)
    unused = tuple(f"{layer}.{i}." for i in range(n_taps, len(network_dc["feature_dims"]))
                   for layer in ("bottleneck_layers", "downsample_layers"))
    before = {n: v.clone() for n, v in model.net_dc.state_dict().items() if n.startswith(unused)}
    arch = network_g["type"]
    jax_params = {}
    for net, spec in ((model.net_g, network_g), (model.net_dc, network_dc)):
        jnet = jax_build_network({k: v for k, v in spec.items() if k != "h"})
        # copies: the port's optimizer updates its parameters in place, and JAX may alias a numpy buffer
        state = {k: v.numpy().copy() for k, v in net.state_dict().items() if not k.startswith(unused)}
        jax_params[type(jnet)] = state_dict_to_params(state, key_map=type(jnet).torch_key_map)

    def given_init(self, *args, **kwargs):
        return {"params": jax.tree_util.tree_map(jax.numpy.asarray, jax_params[type(self)])}

    jopt = opt(tmp_path / "jax")
    jopt["num_gpu"] = 1
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen.Module, "init", given_init)
        mp.setattr(JaxDCModel, "_dummy_features", lambda self, x: None)
        jmodel = jax_build_model(jopt)

    b1, b2 = jopt["train"]["optim_g"]["betas"]
    nets = ((model.net_g, arch, "params_g", "opt_state_g"),
            (model.net_dc, "PromptIR_NoImg_DC", "params_dc", "opt_state_dc"))
    last_mu = {}
    with pytest.MonkeyPatch.context() as mp:
        _smooth_probe(mp, model.net_dc)
        for it, batch in enumerate(_batches(), start=1):
            for net, name, params, _ in nets:
                want = params_to_state_dict(jax.tree_util.tree_map(np.asarray, getattr(jmodel, params)), name)
                net.load_state_dict(want, strict=False)
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

            stepped = {}
            for net, name, params, opt_state in nets:
                mu, nu = (jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), m)
                          for m in _adam_moments(getattr(jmodel, opt_state)))
                prev = last_mu.get(name, jax.tree_util.tree_map(np.zeros_like, mu))
                grad = jax.tree_util.tree_map(lambda m, p: (m - b1 * p) / (1 - b1), mu, prev)
                last_mu[name] = mu
                grad, v_hat = (params_to_state_dict(jax.tree_util.tree_map(lambda a: a.astype(np.float32), t), name)
                               for t in (grad, jax.tree_util.tree_map(lambda a: a / (1 - b2 ** it), nu)))
                want = params_to_state_dict(jax.tree_util.tree_map(np.asarray, getattr(jmodel, params)), name)
                trained = {n: p for n, p in net.named_parameters() if p.grad is not None}
                assert set(trained) == set(want), f"step {it}: {sorted(set(trained) ^ set(want))}"
                stepped[name] = (trained, grad, v_hat, want)
            scale = max(np.abs(grad[n].numpy()).max() for trained, grad, _, _ in stepped.values() for n in trained)
            compared = left_out = 0
            for trained, grad, v_hat, want in stepped.values():
                for n, p in trained.items():
                    g, ref = p.grad.double().numpy(), grad[n].double().numpy()
                    diff = np.abs(g - ref)
                    assert diff.max() <= 1e-4 * np.abs(ref).max() + 1e-6 * scale, \
                        f"step {it} gradient {n}: {diff.max():.3e} against max|g| {np.abs(ref).max():.3e}"
                    kept = np.sqrt(v_hat[n].double().numpy()) >= 100 * diff
                    noise = np.zeros_like(kept)
                    if exact_zero is not None and exact_zero(n) is not None:
                        noise[exact_zero(n)] = True
                        assert max(np.abs(g[noise]).max(), np.abs(ref[noise]).max()) <= 1e-6 * scale, \
                            f"step {it} gradient {n}: not zero where it is in exact arithmetic"
                    kept &= ~noise
                    np.testing.assert_allclose(p.detach().numpy()[kept], want[n].numpy()[kept], rtol=1e-4, atol=1e-5,
                                               err_msg=f"step {it} {n}")
                    compared, left_out = compared + int(kept.sum()), left_out + int((~kept & ~noise).sum())
            assert left_out <= 1e-3 * (compared + left_out), f"step {it}: {left_out} of {compared + left_out} left out"
    for key, value in before.items():
        assert torch.equal(model.net_dc.state_dict()[key], value), key


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
