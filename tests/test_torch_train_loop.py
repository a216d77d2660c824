"""The training half of the PyTorch port's ``SRModel``, ``train.accumulate_steps``,
validation inside the loop and the SIGTERM save, on the CPU.

``SRModel`` and ``accumulate_steps`` are held against dcpt_tpu (the tiny
NAFNet of ``_torch_dc_util``, the same weights and batches; dcpt_tpu
accumulates with ``optax.MultiSteps``).  The loop's features are held against
dcpt_tpu's loop (``dcpt_tpu/train.py``): validation every ``val.val_freq``
iterations and once after the final save, an unknown dataset phase refused,
and a SIGTERM that saves at the iteration in flight, after which
``--auto_resume`` ends where a run that never stopped ends.
"""

import os
import signal

import cv2
import jax
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401
from _torch_dc_util import (ARCHS, TRAINED, assert_states_close, batches, jax_model, jax_steps, options, port_model,
                            port_steps, seeded_weights, to_torch)
from dcpt_tpu_torch.models.sr_model import SRModel
from dcpt_tpu_torch.train import train_pipeline


@pytest.fixture(scope="module")
def weights():
    return seeded_weights()


def test_sr_model_three_steps_match_dcpt_tpu(tmp_path, weights):
    """``l_pix`` and ``l_total`` at every step within rtol 1e-4; ``net_g`` and its
    EMA (decay 0.9) afterwards within rtol 1e-4 / atol 1e-5 of dcpt_tpu's; the
    save writes ``params`` and ``params_ema``."""
    jmodel = jax_model(options(tmp_path / "jax", "SRModel"), weights)
    want_losses, want_g, want_ema = jax_steps(jmodel, "SRModel", weights, batches())
    model = port_model(options(tmp_path / "torch", "SRModel"), weights)
    losses = port_steps(model, batches())
    for it, (got, want) in enumerate(zip(losses, want_losses), start=1):
        assert set(got) == set(want) == {"l_pix", "l_total"}
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=f"step {it} {k}")
    assert_states_close(model.net_g.state_dict(), want_g)
    assert_states_close(model.net_g_ema.state_dict(), want_ema)
    os.makedirs(model.opt["path"]["models"])
    model.save(0, 3)
    assert set(torch.load(tmp_path / "torch" / "models" / "net_g_3.pth", weights_only=True)) == {"params", "params_ema"}


def _params(net):
    return {k: v.clone() for k, v in net.state_dict().items()}


def test_accumulate_steps_match_multisteps_and_a_double_batch(tmp_path, weights):
    """``accumulate_steps`` 2 on two micro-batches of 2: the parameters unchanged
    after the first, the losses, ``net_g`` and its EMA (which moves at every
    micro-iteration) after the second within rtol 1e-4 / atol 1e-5 of dcpt_tpu's
    ``optax.MultiSteps``; and ``net_g`` within rtol 1e-5 / atol 1e-6 (the bar of
    ``tests/test_grad_accum.py``) of one step on the batch of 4 at the second
    iteration's lr."""
    data = batches(n=2)
    jmodel = jax_model(options(tmp_path / "jax", "SRModel", accumulate_steps=2), weights)
    want_losses, want_g, want_ema = jax_steps(jmodel, "SRModel", weights, data)
    model = port_model(options(tmp_path / "torch", "SRModel", accumulate_steps=2), weights)
    start = _params(model.net_g)
    losses = port_steps(model, data[:1])
    assert all(torch.equal(v, start[k]) for k, v in model.net_g.state_dict().items())
    model.update_learning_rate(2)
    model.feed_data(to_torch(data[1]))
    model.optimize_parameters(2)
    for got, want in zip(losses + [dict(model.log_dict)], want_losses):
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    assert_states_close(model.net_g.state_dict(), want_g)
    assert_states_close(model.net_g_ema.state_dict(), want_ema)
    assert model.optimizer_g.state_dict()["state"][0]["step"].item() == 1

    big = port_model(options(tmp_path / "big", "SRModel"), weights)
    big.update_learning_rate(2)
    big.feed_data(to_torch({k: np.concatenate([b[k] for b in data]) for k in ("lq", "gt", "dataset_idx")}))
    big.optimize_parameters(2)
    assert_states_close(model.net_g.state_dict(), big.net_g.state_dict(), rtol=1e-5, atol=1e-6)


def test_accumulate_resume_carries_the_accumulator(tmp_path, weights):
    """A training state saved between the micro-batches holds the running mean
    and the micro-step; the model resumed from it ends the accumulation where
    the model that never stopped ends, bit for bit."""
    data = batches(n=2)
    full = port_model(options(tmp_path / "full", "SRModel", accumulate_steps=2), weights)
    port_steps(full, data)

    first = port_model(options(tmp_path / "a", "SRModel", accumulate_steps=2), weights)
    port_steps(first, data[:1])
    first.save_training_state(0, 1)
    state = torch.load(tmp_path / "a" / "states" / "1.state", weights_only=True)
    assert state["accumulate"]["step"] == 1 and state["accumulate"]["grads"] is not None
    resumed = port_model(options(tmp_path / "b", "SRModel", accumulate_steps=2), weights)
    resumed.resume_training(state)
    resumed.update_learning_rate(2)
    resumed.feed_data(to_torch(data[1]))
    resumed.optimize_parameters(2)
    for k, v in full.net_g.state_dict().items():
        assert torch.equal(resumed.net_g.state_dict()[k], v), k


@pytest.mark.parametrize("model_type", ["DCModel", "DCDistModel", "DCPTModel"])
def test_accumulate_steps_in_every_training_model(tmp_path, weights, model_type):
    """``accumulate_steps`` 2 in the probe, the fine-tune and DCPT (each
    optimizer with its own running mean): every net unchanged after the first
    micro-batch; the losses of both micro-iterations, the trained nets and the
    EMA (which moves at every micro-iteration) after the second within rtol
    1e-4 / atol 1e-5 of dcpt_tpu's ``optax.MultiSteps``; the trained nets
    within rtol 1e-5 / atol 1e-6 of one step on the batch of 4 (every loss a
    batch mean); each optimizer at step 1."""
    from dcpt_tpu_torch.convert.jax_params import params_to_state_dict

    data = batches(n=2)
    jmodel = jax_model(options(tmp_path / "jax", model_type, accumulate_steps=2), weights)
    want_losses, want_trained, want_ema = jax_steps(jmodel, model_type, weights, data)
    trained = TRAINED[model_type][0]
    want = {trained: want_trained}
    if model_type == "DCPTModel":  # DCPT trains the classifier too
        want["dc"] = params_to_state_dict(jax.tree_util.tree_map(np.asarray, jmodel.params_dc), ARCHS["dc"])

    model = port_model(options(tmp_path / "acc", model_type, accumulate_steps=2), weights)
    nets = {k: getattr(model, f"net_{k}") for k in ("g", "dc")}
    start = {k: _params(net) for k, net in nets.items()}
    losses = port_steps(model, data[:1])
    assert all(torch.equal(v, start[k][n]) for k, net in nets.items() for n, v in net.state_dict().items())
    model.update_learning_rate(2)
    model.feed_data(to_torch(data[1]))
    model.optimize_parameters(2)
    for it, (got, want_l) in enumerate(zip(losses + [dict(model.log_dict)], want_losses), start=1):
        assert set(got) == set(want_l)
        for k in want_l:
            np.testing.assert_allclose(got[k], want_l[k], rtol=1e-4, err_msg=f"micro-iteration {it} {k}")
    for k, state in want.items():
        assert_states_close(nets[k].state_dict(), state)
    if want_ema is not None:
        assert_states_close(getattr(model, f"net_{trained}_ema").state_dict(), want_ema)
    frozen = {"DCModel": "g", "DCDistModel": "dc"}.get(model_type)
    if frozen is not None:
        assert all(torch.equal(v, start[frozen][n]) for n, v in nets[frozen].state_dict().items())

    big = port_model(options(tmp_path / "big", model_type), weights)
    big.update_learning_rate(2)
    big.feed_data(to_torch({k: np.concatenate([b[k] for b in data]) for k in ("lq", "gt", "dataset_idx")}))
    big.optimize_parameters(2)
    for k in want:
        assert_states_close(nets[k].state_dict(), getattr(big, f"net_{k}").state_dict(), rtol=1e-5, atol=1e-6)
    assert [o.state_dict()["state"][0]["step"].item() for o in model.optimizers] == [1] * len(model.optimizers)


def _write_yml(root, total_iter=4, val=False, extra_phase=False):
    """An SRModel yml on one 16 x 16 image pair, batch 1.  The images are
    radially symmetric, so the flips and the transpose that the loader draws
    (whatever ``use_hflip`` and ``use_rot`` say, as in dcpt_tpu) leave them as
    they are: every iteration sees the same batch, and a resumed run can end
    where an uninterrupted one does."""
    for sub in ("gt", "lq"):
        os.makedirs(root / "data" / sub, exist_ok=True)
    r = np.hypot(*(np.mgrid[0:16, 0:16] - 7.5))[..., None]
    gt = (127 + 100 * np.cos(r * np.array([0.5, 0.8, 1.3]))).astype(np.uint8)
    cv2.imwrite(str(root / "data" / "gt" / "0.png"), gt)
    cv2.imwrite(str(root / "data" / "lq" / "0.png"), cv2.GaussianBlur(gt, (3, 3), 1))
    pair = f"dataroot_gt: {root}/data/gt\n    dataroot_lq: {root}/data/lq\n    io_backend: {{type: disk}}"
    text = f"""name: loop
model_type: SRModel
scale: 1
num_gpu: 0
manual_seed: 0
datasets:
  train:
    name: d
    type: PairedImageDataset
    {pair}
    gt_size: 16
    use_hflip: false
    use_rot: false
    batch_size_per_gpu: 1
    num_worker_per_gpu: 0
"""
    if val:
        text += f"""  val:
    name: v
    type: PairedImageDataset
    {pair}
    batch_size_per_gpu: 1
    num_worker_per_gpu: 0
"""
    if extra_phase:
        text += f"""  calibration:
    name: c
    type: PairedImageDataset
    {pair}
"""
    text += f"""network_g:
  type: NAFNetBaseline
  width: 8
  enc_blk_nums: [1]
  middle_blk_num: 1
  dec_blk_nums: [1]
path: {{}}
train:
  total_iter: {total_iter}
  ema_decay: 0.9
  optim_g: {{type: AdamW, lr: 1.0e-3}}
  scheduler: {{type: MultiStepRestartLR, milestones: [100000]}}
  pixel_opt: {{type: L1Loss}}
"""
    if val:
        text += """val:
  val_freq: 2
  metrics:
    psnr: {type: calculate_psnr, crop_border: 0}
"""
    text += """logger:
  print_freq: 1
  save_checkpoint_freq: 100000
  use_tb_logger: false
"""
    (root / "t.yml").write_text(text)
    return ["-opt", str(root / "t.yml")]


def test_validation_at_val_freq_and_after_the_final_save(tmp_path, monkeypatch):
    """With ``val_freq`` 2 and 4 iterations the val loader is scored at
    iterations 2 and 4 and once more after the final save (at iteration 5,
    where dcpt_tpu's loop has counted when it stops), on the EMA net."""
    seen = []
    real = SRModel.nondist_validation

    def recording(self, dataloader, current_iter, tb_logger, save_img, clamp=True):
        real(self, dataloader, current_iter, tb_logger, save_img, clamp)
        seen.append((current_iter, dataloader.dataset.opt["name"], self.metric_results["psnr"], self._infer_net()))

    monkeypatch.setattr(SRModel, "nondist_validation", recording)
    model = train_pipeline(str(tmp_path), args=_write_yml(tmp_path, val=True))
    assert [s[:2] for s in seen] == [(2, "v"), (4, "v"), (5, "v")]
    assert all(np.isfinite(s[2]) for s in seen) and all(s[3] is model.net_g_ema for s in seen)
    assert (tmp_path / "experiments" / "loop" / "models" / "net_g_latest.pth").exists()


def test_an_unknown_dataset_phase_raises(tmp_path):
    with pytest.raises(ValueError, match="calibration"):
        train_pipeline(str(tmp_path), args=_write_yml(tmp_path, extra_phase=True))


def test_sigterm_saves_at_the_iteration_and_auto_resume_finishes(tmp_path, monkeypatch):
    """SIGTERM raised inside iteration 2's step: the step finishes, the model and
    the training state are saved at 2 and the run returns; ``--auto_resume``
    then ends at iteration 4 with the parameters, EMA and optimizer state of a
    run that never stopped, bit for bit.  The handler that was in place before
    each run is in place after it."""
    full = train_pipeline(str(tmp_path / "full"), args=_write_yml(tmp_path / "full"))

    real = SRModel.optimize_parameters

    def signalling(self, current_iter):
        real(self, current_iter)
        if current_iter == 2:
            os.kill(os.getpid(), signal.SIGTERM)

    def before(signum, frame):  # noqa: ARG001
        raise AssertionError("the run's own handler should have taken the signal")

    previous = signal.signal(signal.SIGTERM, before)
    try:
        args = _write_yml(tmp_path / "run")
        with monkeypatch.context() as mp:
            mp.setattr(SRModel, "optimize_parameters", signalling)
            stopped = train_pipeline(str(tmp_path / "run"), args=args)
        assert signal.getsignal(signal.SIGTERM) is before
        exp = tmp_path / "run" / "experiments" / "loop"
        assert sorted(os.listdir(exp / "training_states")) == ["2.state"]
        assert (exp / "models" / "net_g_2.pth").exists() and not (exp / "models" / "net_g_latest.pth").exists()
        assert stopped.optimizer_g.state_dict()["state"][0]["step"].item() == 2
        resumed = train_pipeline(str(tmp_path / "run"), args=["--auto_resume", *args])
        assert signal.getsignal(signal.SIGTERM) is before
    finally:
        signal.signal(signal.SIGTERM, previous)
    assert (exp / "models" / "net_g_latest.pth").exists()
    assert resumed.optimizer_g.state_dict()["state"][0]["step"].item() == 4
    for a, b in ((resumed.net_g, full.net_g), (resumed.net_g_ema, full.net_g_ema)):
        for k, v in b.state_dict().items():
            assert torch.equal(a.state_dict()[k], v), k


def _resume_options(tmp_path, saved):
    models = tmp_path / "models"
    models.mkdir(parents=True)
    for label in saved:
        (models / f"net_{label}_2.pth").write_bytes(b"")
    return {"network_g": {}, "network_dc": {},
            "path": {"models": str(models), "resume_state": str(tmp_path / "2.state"),
                     "pretrain_network_g": "stage1/net_g.pth", "param_key_g": "params_ema",
                     "pretrain_network_dc": "stage2/net_dc.pth", "param_key_dc": "params_ema"}}


def test_resume_keeps_the_path_and_key_of_a_net_the_run_did_not_save(tmp_path):
    """The probe saves only ``net_dc``, the fine-tune only ``net_g``: on resume
    the net the model keeps frozen (its ``FROZEN_NETWORKS``) keeps its
    configured snapshot and param key, and the trained one is rewired to the
    run's own snapshot with ``params``.  dcpt_tpu's ``check_resume`` points
    the frozen net at a snapshot the run never wrote (ROADMAP Q3)."""
    from copy import deepcopy

    from dcpt_tpu.utils.misc import check_resume as jax_check_resume
    from dcpt_tpu_torch.utils.misc import check_resume
    from dcpt_tpu_torch.utils.registry import MODEL_REGISTRY

    for model_type, frozen, trained in (("DCModel", "g", "dc"), ("DCDistModel", "dc", "g")):
        root = tmp_path / model_type
        opt = _resume_options(root, saved=[trained])
        jopt, configured = deepcopy(opt), dict(opt["path"])
        assert MODEL_REGISTRY.get(model_type).FROZEN_NETWORKS == (f"network_{frozen}",)
        check_resume(opt, 2, MODEL_REGISTRY.get(model_type).FROZEN_NETWORKS)
        path = opt["path"]
        assert (path[f"pretrain_network_{frozen}"], path[f"param_key_{frozen}"]) == (
            configured[f"pretrain_network_{frozen}"], "params_ema")
        assert (path[f"pretrain_network_{trained}"], path[f"param_key_{trained}"]) == (
            str(root / "models" / f"net_{trained}_2.pth"), "params")
        jax_check_resume(jopt, 2)
        assert not os.path.exists(jopt["path"][f"pretrain_network_{frozen}"])
        assert jopt["path"][f"pretrain_network_{frozen}"].startswith(str(root / "models"))


def test_resume_raises_where_a_trained_net_has_no_snapshot(tmp_path):
    """The probe's ``net_dc`` (and DCPT's, which trains both nets) has no
    snapshot at the resumed iteration: the resume raises, naming it, rather
    than load the net from its configured (stage-1) snapshot beside the
    optimizer state of that iteration."""
    from dcpt_tpu_torch.utils.misc import check_resume
    from dcpt_tpu_torch.utils.registry import MODEL_REGISTRY

    for model_type in ("DCModel", "DCPTModel"):
        opt = _resume_options(tmp_path / model_type, saved=["g"])
        with pytest.raises(FileNotFoundError, match="network_dc.*net_dc_2.pth"):
            check_resume(opt, 2, MODEL_REGISTRY.get(model_type).FROZEN_NETWORKS)
