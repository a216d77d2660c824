"""DCModel (dcpt_tpu/models/degradation_classification_model.py): DCPT's stage-2
probe, and the part of it that DCPTModel inherits (both networks, their
loading, the batch, the top-1 validation).

The probe (reference ``basicsr/models/degradation_classification_model.py``):
``net_g`` is frozen, its parameters take no gradient, and its feature-only
(skip-tail) forward runs under ``torch.no_grad()`` (the reference's detached
hooks), so on the card every NAFBlock takes K1's inference route; the taps
named by ``hook_names``, reversed, go to the classifier, whose cross-entropy
on ``dataset_idx`` trains ``net_dc`` alone through ``optim_dc``.  The EMA
(``train.ema_decay``) is of ``net_dc``.  ``train.mixed_precision`` runs both
nets on bf16 copies of their fp32 parameters (``base_model.py::bf16_call``).
Validation is the top-1 accuracy of each batch, averaged over the batches.
"""

from __future__ import annotations

from copy import deepcopy

import torch
import torch.nn.functional as F

from ..archs import build_network
from ..losses import build_loss
from ..utils.logger import get_root_logger
from ..utils.registry import MODEL_REGISTRY
from .base_model import BaseModel, bf16_call
from .dc_util import accuracy_topk, select_taps
from .sr_model import check_window_size


@MODEL_REGISTRY.register()
class DCModel(BaseModel):
    FROZEN_NETWORKS = ("network_g",)

    def __init__(self, opt: dict):
        super().__init__(opt)
        self.scale = opt.get("scale", 1)
        self.hook_names = opt.get("hook_names")
        # the yml's ``h`` is an init-shape hint of dcpt_tpu; PyTorch modules need none
        self.net_g = build_network({k: v for k, v in opt["network_g"].items() if k != "h"}).to(self.device)
        self.net_dc = build_network(opt["network_dc"]).to(self.device)
        self.print_network(self.net_g)
        self.print_network(self.net_dc)
        self._load_both()
        self.net_dc_ema = None
        if self.is_train:
            self.init_training_settings()

    def _load_both(self) -> None:
        path_opt = self.opt["path"]
        for label, net in (("g", self.net_g), ("dc", self.net_dc)):
            load_path = path_opt.get(f"pretrain_network_{label}")
            if load_path is not None:
                self.load_network(net, load_path, path_opt.get(f"strict_load_{label}", True),
                                  path_opt.get(f"param_key_{label}", "params"))

    def init_training_settings(self) -> None:
        self._check_train_options()
        train_opt = self.opt["train"]
        self.net_g.eval().requires_grad_(False)
        self.net_dc.train()
        self.ema_decay = train_opt.get("ema_decay", 0)
        if self.ema_decay > 0:
            get_root_logger().info(f"Use Exponential Moving Average with decay: {self.ema_decay}")
            self.net_dc_ema = deepcopy(self.net_dc).eval().requires_grad_(False)
        self.cri_classify = build_loss(train_opt["classify_opt"]) if train_opt.get("classify_opt") else None
        if self.cri_classify is None:
            raise ValueError("Classify loss is None.")
        self.setup_optimizers()
        self.setup_schedulers()

    def setup_optimizers(self) -> None:
        optim_opt = dict(self.opt["train"]["optim_dc"])
        optim_type = optim_opt.pop("type")
        self.optimizer_dc = self.get_optimizer(optim_type, self.net_dc.parameters(), **optim_opt)
        self.optimizers = [self.optimizer_dc]

    def feed_data(self, data: dict) -> None:
        self.lq = data["lq"].to(self.device, non_blocking=True)
        self.dataset_idx = data["dataset_idx"].to(self.device, non_blocking=True)
        self.gt = data["gt"].to(self.device, non_blocking=True) if "gt" in data else None

    def compute_gradients(self) -> dict:
        """The frozen net's taps, the classifier's loss and one backward into
        ``net_dc``'s ``.grad``; returns the loss."""
        self.optimizer_dc.zero_grad(set_to_none=True)
        lq = self.lq.to(torch.bfloat16) if self.mixed_precision else self.lq
        with torch.no_grad():
            _, taps = (bf16_call(self.net_g) if self.mixed_precision else self.net_g)(lq, skip_tail=True)
        net_dc = bf16_call(self.net_dc) if self.mixed_precision else self.net_dc
        logits = net_dc(lq, select_taps(taps, self.hook_names)[::-1])
        l_classify = self.cri_classify(logits.float(), self.dataset_idx)
        l_classify.backward()
        return {"l_classify": l_classify}

    def optimize_parameters(self, current_iter: int) -> None:
        losses = self.compute_gradients()
        self.step_optimizers()
        if self.net_dc_ema is not None:
            self.ema_update(self.net_dc_ema, self.net_dc, self.ema_decay)
        self.log_dict = self.reduce_loss_dict({k: v.detach() for k, v in losses.items()})

    # -- eval --------------------------------------------------------------------------

    def pre_test(self) -> None:
        """Reflect-pad H, W to the arch's ``window_size`` multiple where it has one."""
        self.mod_pad_h = self.mod_pad_w = 0
        if "window_size" not in self.opt["network_g"]:
            return
        ws = check_window_size(self.opt["network_g"]["window_size"])
        _, _, h, w = self.lq.shape
        self.mod_pad_h, self.mod_pad_w = (ws - h % ws) % ws, (ws - w % ws) % ws
        if self.mod_pad_h or self.mod_pad_w:
            self.lq = F.pad(self.lq, (0, self.mod_pad_w, 0, self.mod_pad_h), mode="reflect")

    def classify(self, net_dc: torch.nn.Module | None = None) -> torch.Tensor:
        """The classifier's logits on ``lq`` (the EMA classifier when there is one)."""
        if net_dc is None:
            net_dc = self.net_dc_ema if self.net_dc_ema is not None else self.net_dc
        with torch.inference_mode():
            _, taps = self.net_g(self.lq, skip_tail=True)
            return net_dc(self.lq, select_taps(taps, self.hook_names)[::-1])

    def nondist_validation(self, dataloader, current_iter, tb_logger, save_img=False, clamp=True):
        """Top-1 accuracy of each batch, averaged over the batches, and the best
        so far (reference: …model.py:229-289)."""
        if not hasattr(self, "best_metric_results") or "top-1" not in self.best_metric_results:
            self.best_metric_results = {"top-1": dict(val=0.0, iter=-1)}
        self.metric_results = {"top-1": 0.0}
        n_batches = 0
        for val_data in dataloader:
            n_batches += 1
            self.feed_data(val_data)
            self.pre_test()
            self.metric_results["top-1"] += float(accuracy_topk(self.classify(), self.dataset_idx)[0])
        if n_batches == 0:
            return
        for metric in self.metric_results:
            self.metric_results[metric] /= n_batches
            rec = self.best_metric_results[metric]
            if self.metric_results[metric] >= rec["val"]:
                rec["val"], rec["iter"] = self.metric_results[metric], current_iter
        log_str = "Validation Degradation Classifier.\n"
        for metric, value in self.metric_results.items():
            rec = self.best_metric_results[metric]
            log_str += f"\t # {metric}: {value:.4f}\tBest: {rec['val']:.4f} @ {rec['iter']} iter\n"
        get_root_logger().info(log_str)
        if tb_logger:
            for metric, value in self.metric_results.items():
                tb_logger.add_scalar(f"metrics/{metric}", value, current_iter)

    def save(self, epoch: int, current_iter: int) -> None:
        """``net_dc`` (``params``, and ``params_ema`` with an EMA) and the training state."""
        nets = {"params": self.net_dc}
        if self.net_dc_ema is not None:
            nets["params_ema"] = self.net_dc_ema
        self.save_network(nets, "net_dc", current_iter)
        self.save_training_state(epoch, current_iter)
