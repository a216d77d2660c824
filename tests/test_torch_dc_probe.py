"""DCPT's stage-2 probe (``DCModel``) of the PyTorch port against dcpt_tpu's, on
the CPU.

A width-8 two-level NAFNet (frozen) and a two-level PromptIR_NoImg_DC
classifier start from the same weights in both packages (``_torch_dc_util``)
and take the same three seeded batches: the classifier alone trains (AdamW, lr
1e-4), its EMA follows (decay 0.9), and ``net_g`` keeps every bit.  On the CPU
every NAFBlock runs K1's plain version under ``torch.no_grad()`` and the
classifier's LayerNorms K3's.
"""

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401
from _torch_dc_util import (Loader, assert_states_close, batches, jax_model, jax_steps, jax_tree, mixed_bar, options,
                            port_model, port_steps, seeded_weights, to_torch)


@pytest.fixture(scope="module")
def probe(tmp_path_factory):
    """The weights, dcpt_tpu's DCModel on them, and its fp32 and bf16 three-step runs."""
    weights = seeded_weights()
    jmodel = jax_model(options(tmp_path_factory.mktemp("jax"), "DCModel"), weights)
    runs = {mixed: jax_steps(jmodel, "DCModel", weights, batches(), mixed) for mixed in (False, True)}
    return weights, jmodel, runs


def test_three_steps_match_dcpt_tpu(tmp_path, probe):
    """The loss at every step within rtol 1e-4; the classifier and its EMA
    afterwards within rtol 1e-4 / atol 1e-5 of dcpt_tpu's; ``net_g`` bit for
    bit unchanged and without gradients."""
    weights, _, runs = probe
    want_losses, want_dc, want_ema = runs[False]
    model = port_model(options(tmp_path, "DCModel"), weights)
    before = {k: v.clone() for k, v in model.net_g.state_dict().items()}
    losses = port_steps(model, batches())
    for it, (got, want) in enumerate(zip(losses, want_losses), start=1):
        assert set(got) == set(want) == {"l_classify"}
        np.testing.assert_allclose(got["l_classify"], want["l_classify"], rtol=1e-4, err_msg=f"step {it}")
    assert_states_close(model.net_dc.state_dict(), want_dc)
    assert_states_close(model.net_dc_ema.state_dict(), want_ema)
    assert all(torch.equal(v, before[k]) for k, v in model.net_g.state_dict().items())
    assert all(p.grad is None and not p.requires_grad for p in model.net_g.parameters())
    assert model.optimizers == [model.optimizer_dc]


def test_three_mixed_steps_match_dcpt_tpu(tmp_path, probe):
    """``train.mixed_precision``: both nets on bf16 copies of their fp32 masters,
    held to dcpt_tpu's bf16 run by ``mixed_bar`` (its own fp32-to-bf16 spread);
    the masters and AdamW's moments stay fp32."""
    weights, _, runs = probe
    model = port_model(options(tmp_path, "DCModel", mixed_precision=True), weights)
    losses = port_steps(model, batches())
    mixed_bar(losses, model.net_dc.state_dict(), runs[True][:2], runs[False][:2])
    assert {p.dtype for p in model.net_dc.parameters()} == {torch.float32}
    assert {v.dtype for st in model.optimizer_dc.state.values() for k, v in st.items() if k.startswith("exp_avg")} \
        == {torch.float32}


def test_top1_validation_matches_dcpt_tpu(tmp_path, probe):
    """Top-1 of each batch (18 x 18 images, reflect-padded to 20 by the
    window size 4), averaged over the batches, equal to dcpt_tpu's, on the EMA
    classifier; the best value and its iteration kept."""
    weights, jmodel, _ = probe
    model = port_model(options(tmp_path, "DCModel"), weights)
    data = batches(n=3, b=4, hw=18, seed=5)
    jmodel.params_dc_ema = jax_tree(jmodel, "dc", weights["dc"])
    jmodel.nondist_validation(data, 7, None)
    model.nondist_validation(Loader([to_torch(b) for b in data]), 7, None)
    assert model.metric_results == pytest.approx(jmodel.metric_results, abs=0) and model.metric_results["top-1"] > 0
    assert model.best_metric_results == {"top-1": {"val": model.metric_results["top-1"], "iter": 7}}


def test_save_and_resume(tmp_path, probe):
    """``save`` writes ``net_dc`` (``params`` and ``params_ema``) and the
    training state; a model resumed from them takes step 3 as the model that
    never stopped does, bit for bit."""
    weights, _, _ = probe
    data = batches()
    full = port_model(options(tmp_path / "full", "DCModel"), weights)
    port_steps(full, data)

    first = port_model(options(tmp_path / "a", "DCModel"), weights)
    port_steps(first, data[:2])
    (tmp_path / "a" / "models").mkdir(parents=True)
    first.save(epoch=0, current_iter=2)
    saved = torch.load(tmp_path / "a" / "models" / "net_dc_2.pth", weights_only=True)
    assert set(saved) == {"params", "params_ema"}
    assert all(torch.equal(saved["params_ema"][k], v) for k, v in first.net_dc_ema.state_dict().items())

    opt = options(tmp_path / "b", "DCModel")
    opt["path"]["pretrain_network_dc"] = str(tmp_path / "a" / "models" / "net_dc_2.pth")
    resumed = port_model(opt, {"g": weights["g"], "dc": {k: v.numpy() for k, v in saved["params"].items()}})
    resumed.resume_training(torch.load(tmp_path / "a" / "states" / "2.state", weights_only=True))
    resumed.update_learning_rate(3)
    resumed.feed_data(to_torch(data[2]))
    resumed.optimize_parameters(3)
    for k, v in full.net_dc.state_dict().items():
        assert torch.equal(resumed.net_dc.state_dict()[k], v), k
