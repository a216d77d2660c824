"""DCDistModel (dcpt_tpu/models/degradation_classification_distillation_model.py):
DCPT's stage-3 fine-tune, the restoration net trained with a frozen classifier
as its regulariser.

One full forward of ``net_g`` on ``lq`` gives the restored image and the taps:
the pixel loss (``l_pixel``) against ``gt``, and the taps, reversed, through
the frozen ``net_dc`` for the classification loss (``l_classify``) on
``dataset_idx``, taken from the batch or broadcast from the yml's
``dataset_idx``.  ``net_dc``'s parameters take no gradient, but the gradients
flow through it into ``net_g``'s taps: on the card each tapped NAFBlock's K2
takes the sum of the cotangents from the next block and from the classifier,
and the classifier's wide LayerNorms run K3 forward and backward.  The EMA of
``net_g`` starts as its copy.  Restormer_origin's taps go through the
reference's hard-coded block filter (``select_taps_restormer_origin``).

Test-time quirks kept from the reference (:239-250, :349-359 there):
``test`` center-crops ``lq`` to 128 after restoring (torchvision's
``center_crop``, zero padding below 128); the metrics are accumulated once per
image path, each time over the whole batch, and divided by the number of
batches; ``validation`` takes per-loader ``clamp`` and ``dataset_idx`` (the
latter unused upstream).
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
from .base_model import bf16_call
from .dc_util import select_taps, select_taps_restormer_origin
from .sr_model import SRModel


def center_crop_tv(x: torch.Tensor, size: int) -> torch.Tensor:
    """torchvision's ``F.center_crop`` on an NCHW tensor: zero padding where the
    image is smaller than ``size``, then the crop at ``round((dim - size) / 2)``."""
    h, w = x.shape[-2:]
    pad_l, pad_r = ((size - w) // 2, (size - w + 1) // 2) if size > w else (0, 0)
    pad_t, pad_b = ((size - h) // 2, (size - h + 1) // 2) if size > h else (0, 0)
    if pad_l or pad_r or pad_t or pad_b:
        x = F.pad(x, (pad_l, pad_r, pad_t, pad_b))
        h, w = x.shape[-2:]
    top, left = int(round((h - size) / 2.0)), int(round((w - size) / 2.0))
    return x[..., top:top + size, left:left + size]


@MODEL_REGISTRY.register()
class DCDistModel(SRModel):
    FROZEN_NETWORKS = ("network_dc",)

    def __init__(self, opt: dict):
        self.hook_names = opt.get("hook_names")
        self._use_restormer_filter = opt["network_g"].get("type") == "Restormer_origin"
        super().__init__(opt)

    def _select(self, taps: dict) -> list:
        if self._use_restormer_filter:
            feats = select_taps_restormer_origin(taps, self.hook_names)
            if feats:
                return feats
        return select_taps(taps, self.hook_names)

    def init_training_settings(self) -> None:
        self._check_train_options()
        train_opt = self.opt["train"]
        self.net_g.train()
        # the frozen classifier (…distillation_model.py:60-64)
        self.net_dc = build_network(self.opt["network_dc"]).to(self.device)
        self.print_network(self.net_dc)
        load_path = self.opt["path"].get("pretrain_network_dc")
        if load_path is not None:
            self.load_network(self.net_dc, load_path, self.opt["path"].get("strict_load_dc", True),
                              self.opt["path"].get("param_key_dc", "params"))
        self.net_dc.eval().requires_grad_(False)
        self.ema_decay = train_opt.get("ema_decay", 0)
        if self.ema_decay > 0:
            get_root_logger().info(f"Use Exponential Moving Average with decay: {self.ema_decay}")
            self.net_g_ema = deepcopy(self.net_g).eval().requires_grad_(False)
        if train_opt.get("ldl_opt"):
            raise NotImplementedError("train.ldl_opt is not ported to dcpt_tpu_torch yet (ROADMAP Q1 #6)")
        self.cri_pix = build_loss(train_opt["pixel_opt"]) if train_opt.get("pixel_opt") else None
        self.cri_classify = build_loss(train_opt["classify_opt"]) if train_opt.get("classify_opt") else None
        self.setup_optimizers()
        self.setup_schedulers()

    def feed_data(self, data: dict) -> None:
        super().feed_data(data)
        if "dataset_idx" in data:
            self.dataset_idx = data["dataset_idx"].to(self.device)
        if "dataset_idx" in self.opt:  # the yml's constant, broadcast over the batch (:144-149)
            self.dataset_idx = torch.full((self.lq.shape[0],), int(self.opt["dataset_idx"]), dtype=torch.long,
                                          device=self.device)

    def compute_gradients(self) -> dict:
        """One forward of ``net_g``, both losses and one backward of their sum into
        ``net_g``'s ``.grad`` (through the frozen classifier); returns the losses."""
        self.optimizer_g.zero_grad(set_to_none=True)
        if self.mixed_precision:
            net_g, net_dc, lq = bf16_call(self.net_g), bf16_call(self.net_dc), self.lq.to(torch.bfloat16)
        else:
            net_g, net_dc, lq = self.net_g, self.net_dc, self.lq
        output, taps = net_g(lq)
        losses, total = {}, 0.0
        if self.cri_pix is not None:
            losses["l_pixel"] = self.cri_pix(output.float(), self.gt)
            total = total + losses["l_pixel"]
        if self.cri_classify is not None:
            logits = net_dc(lq, self._select(taps)[::-1])
            losses["l_classify"] = self.cri_classify(logits.float(), self.dataset_idx)
            total = total + losses["l_classify"]
        total.backward()
        return losses

    # -- eval (reference: …distillation_model.py:239-460) -------------------------------

    def test(self) -> None:
        """The forward, then ``lq`` center-cropped to 128 (:239-250)."""
        with torch.inference_mode():
            self.pix_output, _ = self._infer_net()(self.lq)
        self.output = self.pix_output
        self.lq = center_crop_tv(self.lq, 128)

    def post_test(self) -> None:
        if "window_size" not in self.opt["network_g"]:
            return
        _, _, h, w = self.pix_output.shape
        self.pix_output = self.pix_output[:, :, : h - self.mod_pad_h * self.scale, : w - self.mod_pad_w * self.scale]
        self.output = self.pix_output

    def get_current_visuals(self) -> OrderedDict:
        out = OrderedDict()
        out["lq"] = self.lq.detach().float().cpu().numpy()
        out["result"] = self.pix_output.detach().float().cpu().numpy()
        if self.gt is not None:
            out["gt"] = self.gt.detach().float().cpu().numpy()
        return out

    def validation(self, dataloader, current_iter, tb_logger, save_img=False, clamp=True, dataset_idx=0):
        self.nondist_validation(dataloader, current_iter, tb_logger, save_img, clamp, dataset_idx)

    def nondist_validation(self, dataloader, current_iter, tb_logger, save_img, clamp=True, dataset_idx=0):
        """PSNR / SSIM as the reference takes them: once per image path, each time
        over the whole batch (:349-359), divided by the number of batches."""
        if save_img:
            raise NotImplementedError("save_img is not ported to dcpt_tpu_torch yet")
        dataset_name = dataloader.dataset.opt["name"]
        with_metrics = self.opt["val"].get("metrics") is not None
        if with_metrics:
            self._initialize_best_metric_results(dataset_name)
            self.metric_results = {metric: 0 for metric in self.opt["val"]["metrics"]}
        n_batches = 0
        for val_data in dataloader:
            n_batches += 1
            self.feed_data(val_data)
            self.pre_test()
            self.test()
            self.post_test()
            visuals = self.get_current_visuals()
            result, gt = visuals["result"], visuals.get("gt")
            if clamp:
                result = np.clip(result, 0, 1)
                gt = np.clip(gt, 0, 1) if gt is not None else None
            del self.lq
            self.pix_output = self.output = self.gt = None
            if with_metrics:
                for _ in val_data["lq_path"]:
                    for name, opt_ in self.opt["val"]["metrics"].items():
                        self.metric_results[name] += calculate_metric({"img": result, "img2": gt},
                                                                      dict(opt_, input_order="BCHW"))
        if with_metrics and n_batches > 0:
            for metric in self.metric_results:
                self.metric_results[metric] /= n_batches
                if clamp:
                    self._update_best_metric_result(dataset_name, metric, self.metric_results[metric], current_iter)
            if clamp:
                self._log_validation_metric_values(current_iter, dataset_name, tb_logger)
