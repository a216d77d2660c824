"""The float64 gradient check of ``chip_smoke.py`` (``dcpt_tpu_torch.tools.grad_check``)
on a tiny DCPT step on the CPU, and cuDNN's algorithm timing in the entry points.

The check holds each gradient tensor of an fp32 path to the float64 step's
within ``max(1e-3 of max|ref|, K x its rounding sensitivity)``, the
sensitivity the largest error of five plain fp32 runs (as it is and on
parameters and inputs moved by one ulp), the path's error the median of its
own five runs.  Here the unplanted fp32 step passes it, and a 1 % error
planted in the step's gradient of any one tensor whose limit is below 1 % of
its max fails it.
"""

import numpy as np
import pytest
import torch

from dcpt_tpu_torch import test as test_entry
from dcpt_tpu_torch import train as train_entry
from dcpt_tpu_torch.models import build_model
from dcpt_tpu_torch.tools import grad_check
from test_torch_dcpt import _batches, _opt


@pytest.fixture(scope="module")
def step(tmp_path_factory):
    """A width-8 NAFNet and its probe (the shipped DCPT recipe), random norms and
    residual scales; the float64 reference, the sensitivity and the fp32 runs."""
    torch.manual_seed(0)
    model = build_model(_opt(tmp_path_factory.mktemp("grad_check"), "DCPTModel"))
    with torch.no_grad():
        for name, p in model.net_g.named_parameters():
            if name.endswith(("beta", "gamma")) or ".norm" in name:
                p.normal_(1.0 if name.endswith("weight") else 0.0, 0.5)
    b = _batches(1)[0]
    batch = {"lq": torch.from_numpy(b["lq"].transpose(0, 3, 1, 2).copy()),
             "gt": torch.from_numpy(b["gt"].transpose(0, 3, 1, 2).copy()),
             "dataset_idx": torch.from_numpy(b["dataset_idx"])}
    before = {n: p.detach().clone() for n, p in model.net_g.named_parameters()}
    ref, ref_losses = grad_check.step_grads(model, batch, torch.float64)
    errs, losses = grad_check.run_errors(model, batch, ref)
    return model, batch, before, ref, ref_losses, grad_check.rounding_sensitivity(errs), errs, losses


def test_planted_gradient_error_fails_the_check(step):
    model, batch, before, ref, ref_losses, sens, errs, losses = step
    # the perturbed steps leave the fp32 masters as they were, bit for bit
    for n, p in model.net_g.named_parameters():
        assert p.dtype == torch.float32 and torch.equal(p, before[n]), n
    report = grad_check.compare(grad_check.path_error(errs), losses, ref, ref_losses, sens)
    assert report["ok"], grad_check.describe(report)
    assert report["worst_ratio"] < 0.1
    tight = [n for n, g in ref.items() if grad_check.K * sens[n] < 1e-2 * g.abs().max().item()]
    # the probe's last layer sits after every switch of the step: its limit is the floor
    assert "net_dc.fc.weight" in tight and len(tight) >= len(ref) // 5
    params = {f"{k}.{n}": p for k, net in (("net_g", model.net_g), ("net_dc", model.net_dc))
              for n, p in net.named_parameters()}
    for n in tight:
        # 1 % of the tensor's max|ref| at its largest element, in the step as it runs
        handle = params[n].register_hook(lambda g: g * 1.01)
        try:
            planted, planted_losses = grad_check.run_errors(model, batch, ref, seeds=())
        finally:
            handle.remove()
        report = grad_check.compare(grad_check.path_error(planted), planted_losses, ref, ref_losses, sens)
        assert not report["ok"] and report["worst"] == n, n


def test_planted_loss_error_fails_the_check(step):
    _, _, _, ref, ref_losses, sens, errs, losses = step
    err = grad_check.path_error(errs)
    planted = {k: v * (1 + 1e-4) for k, v in losses.items()}
    assert not grad_check.compare(err, planted, ref, ref_losses, sens)["ok"]
    assert np.isclose(grad_check.compare(err, losses, ref, ref_losses, sens)["loss_err"], 0.0, atol=1e-6)


class _Stop(Exception):
    pass


@pytest.mark.parametrize("entry", ["train", "test"])
def test_pipelines_turn_on_cudnn_timing(monkeypatch, entry):
    """``train_pipeline`` and ``test_pipeline`` set ``torch.backends.cudnn.benchmark``
    before they read the options, as the reference's entry points do."""
    module = train_entry if entry == "train" else test_entry
    pipeline = train_entry.train_pipeline if entry == "train" else test_entry.test_pipeline

    def stop(*args, **kwargs):
        raise _Stop

    monkeypatch.setattr(module, "parse_options", stop)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    with pytest.raises(_Stop):
        pipeline(".", args=[])
    assert torch.backends.cudnn.benchmark is True
