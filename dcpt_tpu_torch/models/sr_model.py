"""SRModel (dcpt_tpu/models/sr_model.py): restoration training and eval.

Training (reference sr_model.py:113-240, 699-712 there): ``optimize_parameters``
is one forward of ``net_g`` on ``lq``, the pixel loss against ``gt``, one
backward, the clip and ``optim_g``'s step (``BaseModel.step_optimizers``, which
also keeps ``train.accumulate_steps``), then the EMA update of ``net_g_ema``
(``train.ema_decay``; loaded from the pretrained snapshot's ``params_ema``
where ``pretrain_network_g`` is set, else a copy of ``net_g``).
``train.mixed_precision`` runs the net on bf16 copies of its fp32 masters
(``base_model.py::bf16_call``), as ``DCPTModel`` does.  ``ldl_opt`` is not
ported yet and raises (ROADMAP Q1 #6).

Eval: ``pre_test`` reflect-pads H, W to the arch's ``window_size`` multiple (or
``val.pad_multiple``) and ``post_test`` crops back (reference
sr_model.py:234-271); ``test`` runs the EMA net when there is one, else
``net_g``, under ``torch.inference_mode``; ``nondist_validation`` scores the
[0, 1]-clamped output with the host numpy metrics (reference sr_model.py:
375-499).  ``test_tile``, the self-ensemble and ``save_img`` are not ported yet
and raise.
"""

from __future__ import annotations

from collections import OrderedDict
from copy import deepcopy

import numpy as np
import torch
import torch.nn.functional as F

from ..archs import build_network
from ..losses import build_loss
from ..metrics import calculate_metric
from ..utils.logger import get_root_logger
from ..utils.registry import MODEL_REGISTRY
from .base_model import BaseModel, bf16_call


def check_window_size(window_size):
    """A list or tuple window size collapses to its largest (dcpt_tpu's sr_model.py:51-55)."""
    if isinstance(window_size, (tuple, list)):
        return max(window_size)
    return window_size


@MODEL_REGISTRY.register()
class SRModel(BaseModel):
    def __init__(self, opt: dict):
        super().__init__(opt)
        self.scale = opt.get("scale", 1)
        self.net_g = build_network(opt["network_g"]).to(self.device).eval()
        self.print_network(self.net_g)
        self.net_g_ema = None
        load_path = opt["path"].get("pretrain_network_g")
        if load_path is not None:
            self.load_network(self.net_g, load_path, opt["path"].get("strict_load_g", True),
                              opt["path"].get("param_key_g", "params"))
        if self.is_train:
            self.init_training_settings()

    # -- training ------------------------------------------------------------------

    def init_training_settings(self) -> None:
        self._check_train_options()
        train_opt = self.opt["train"]
        self.net_g.train()
        self.ema_decay = train_opt.get("ema_decay", 0)
        if self.ema_decay > 0:
            get_root_logger().info(f"Use Exponential Moving Average with decay: {self.ema_decay}")
            load_path = self.opt["path"].get("pretrain_network_g")
            self.net_g_ema = deepcopy(self.net_g).eval().requires_grad_(False)
            if load_path is not None:
                self.load_network(self.net_g_ema, load_path, self.opt["path"].get("strict_load_g", True),
                                  "params_ema")
        if train_opt.get("ldl_opt"):
            raise NotImplementedError("train.ldl_opt is not ported to dcpt_tpu_torch yet (ROADMAP Q1 #6)")
        if train_opt.get("perceptual_opt"):
            get_root_logger().warning("perceptual_opt configured but PerceptualLoss is not shipped (matches reference).")
        self.cri_pix = build_loss(train_opt["pixel_opt"]) if train_opt.get("pixel_opt") else None
        if self.cri_pix is None:
            raise ValueError("Both pixel and perceptual losses are None.")
        self.setup_optimizers()
        self.setup_schedulers()

    def setup_optimizers(self) -> None:
        optim_opt = dict(self.opt["train"]["optim_g"])
        optim_type = optim_opt.pop("type")
        self.optimizer_g = self.get_optimizer(optim_type, self.net_g.parameters(), **optim_opt)
        self.optimizers = [self.optimizer_g]

    def compute_gradients(self) -> dict:
        """The forward, the pixel loss and one backward into ``net_g``'s ``.grad``;
        returns the losses."""
        self.optimizer_g.zero_grad(set_to_none=True)
        if self.mixed_precision:
            output, _ = bf16_call(self.net_g)(self.lq.to(torch.bfloat16))
        else:
            output, _ = self.net_g(self.lq)
        l_pix = self.cri_pix(output.float(), self.gt)
        l_pix.backward()
        return {"l_pix": l_pix, "l_total": l_pix}

    def optimize_parameters(self, current_iter: int) -> None:
        losses = self.compute_gradients()
        self.step_optimizers()
        if self.net_g_ema is not None:  # every iteration, micro-iterations too, as dcpt_tpu's step does
            self.ema_update(self.net_g_ema, self.net_g, self.ema_decay)
        self.log_dict = self.reduce_loss_dict({k: v.detach() for k, v in losses.items()})

    def save(self, epoch: int, current_iter: int) -> None:
        """``net_g`` (``params``, and ``params_ema`` with an EMA) and the training state."""
        nets = {"params": self.net_g}
        if self.net_g_ema is not None:
            nets["params_ema"] = self.net_g_ema
        self.save_network(nets, "net_g", current_iter)
        self.save_training_state(epoch, current_iter)

    # -- eval --------------------------------------------------------------------------

    def feed_data(self, data: dict) -> None:
        self.lq = data["lq"].to(self.device)
        self.gt = data["gt"].to(self.device) if "gt" in data else None

    def pre_test(self) -> None:
        """Reflect-pad H, W to window-size multiples (sr_model.py:244-260), or to
        the larger ``val.pad_multiple`` where the yml sets one (dcpt_tpu's shape buckets)."""
        self.mod_pad_h, self.mod_pad_w = 0, 0
        window_size = check_window_size(self.opt["network_g"].get("window_size", 1))
        multiple = max(window_size, (self.opt.get("val") or {}).get("pad_multiple") or 0)
        if multiple <= 1:
            return
        _, _, h, w = self.lq.shape
        self.mod_pad_h = (multiple - h % multiple) % multiple
        self.mod_pad_w = (multiple - w % multiple) % multiple
        if self.mod_pad_h or self.mod_pad_w:
            self.lq = F.pad(self.lq, (0, self.mod_pad_w, 0, self.mod_pad_h), mode="reflect")

    def _infer_net(self) -> torch.nn.Module:
        return self.net_g_ema if self.net_g_ema is not None else self.net_g

    def test(self) -> None:
        with torch.inference_mode():
            self.output, _ = self._infer_net()(self.lq)

    def post_test(self) -> None:
        _, _, h, w = self.output.shape
        self.output = self.output[:, :, : h - self.mod_pad_h * self.scale, : w - self.mod_pad_w * self.scale]

    def get_current_visuals(self) -> OrderedDict:
        out = OrderedDict()
        out["result"] = self.output.detach().float().cpu().numpy()
        if self.gt is not None:
            out["gt"] = self.gt.detach().float().cpu().numpy()
        return out

    def nondist_validation(self, dataloader, current_iter, tb_logger, save_img, clamp=True):
        """The metrics over the loader, averaged over its batches; with ``clamp``
        False the images are scored unclamped and the best results and the log
        are left alone (reference: sr_model.py:375-499)."""
        if "tile" in self.opt or self.opt.get("ensemble"):
            raise NotImplementedError("test_tile and the self-ensemble are not ported to dcpt_tpu_torch yet")
        if save_img:
            raise NotImplementedError("save_img is not ported to dcpt_tpu_torch yet")
        dataset_name = dataloader.dataset.opt["name"]
        with_metrics = self.opt["val"].get("metrics") is not None
        if with_metrics:
            self._initialize_best_metric_results(dataset_name)
            self.metric_results = {metric: 0 for metric in self.opt["val"]["metrics"]}

        n_seen = 0
        for val_data in dataloader:
            n_seen += 1
            self.feed_data(val_data)
            self.pre_test()
            self.test()
            self.post_test()
            visuals = self.get_current_visuals()
            result, gt = visuals["result"], visuals.get("gt")
            if clamp:
                result = np.clip(result, 0, 1)
                gt = np.clip(gt, 0, 1) if gt is not None else None
            del self.lq, self.output
            self.gt = None
            if with_metrics:
                for name, opt_ in self.opt["val"]["metrics"].items():
                    if str(opt_.get("type", "")).endswith("_device"):
                        raise NotImplementedError(f"device metric {opt_['type']} is not ported yet")
                    self.metric_results[name] += calculate_metric({"img": result, "img2": gt},
                                                                  dict(opt_, input_order="BCHW"))

        if with_metrics and n_seen > 0:
            for metric in self.metric_results:
                self.metric_results[metric] /= n_seen
                if clamp:
                    self._update_best_metric_result(dataset_name, metric, self.metric_results[metric], current_iter)
            if clamp:
                self._log_validation_metric_values(current_iter, dataset_name, tb_logger)

    def _log_validation_metric_values(self, current_iter, dataset_name, tb_logger=None):
        log_str = f"Validation {dataset_name}\n"
        for metric, value in self.metric_results.items():
            rec = self.best_metric_results[dataset_name][metric]
            log_str += f"\t # {metric}: {value:.4f}\tBest: {rec['val']:.4f} @ {rec['iter']} iter\n"
        get_root_logger().info(log_str)
        if tb_logger:
            for metric, value in self.metric_results.items():
                tb_logger.add_scalar(f"metrics/{dataset_name}/{metric}", value, current_iter)
