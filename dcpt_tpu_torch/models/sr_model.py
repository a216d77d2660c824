"""SRModel, eval half (dcpt_tpu/models/sr_model.py): pad, forward, unpad, score.

``pre_test`` reflect-pads H, W to the arch's ``window_size`` multiple (or
``val.pad_multiple``) and ``post_test`` crops back (reference
sr_model.py:234-271); ``test`` runs the network under
``torch.inference_mode``; ``nondist_validation`` scores the
[0, 1]-clamped output with the host numpy metrics (reference sr_model.py:
375-499).  ``test_tile``, the self-ensemble and ``save_img`` are not ported yet
and raise.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch
import torch.nn.functional as F

from ..archs import build_network
from ..metrics import calculate_metric
from ..utils.logger import get_root_logger
from ..utils.registry import MODEL_REGISTRY
from .base_model import BaseModel


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
        load_path = opt["path"].get("pretrain_network_g")
        if load_path is not None:
            self.load_network(self.net_g, load_path, opt["path"].get("strict_load_g", True),
                              opt["path"].get("param_key_g", "params"))

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

    def test(self) -> None:
        with torch.inference_mode():
            self.output, _ = self.net_g(self.lq)

    def post_test(self) -> None:
        _, _, h, w = self.output.shape
        self.output = self.output[:, :, : h - self.mod_pad_h * self.scale, : w - self.mod_pad_w * self.scale]

    def get_current_visuals(self) -> OrderedDict:
        out = OrderedDict()
        out["result"] = self.output.detach().float().cpu().numpy()
        if self.gt is not None:
            out["gt"] = self.gt.detach().float().cpu().numpy()
        return out

    def nondist_validation(self, dataloader, current_iter, tb_logger, save_img):
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
            result = np.clip(visuals["result"], 0, 1)
            gt = np.clip(visuals["gt"], 0, 1) if "gt" in visuals else None
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
                self._update_best_metric_result(dataset_name, metric, self.metric_results[metric], current_iter)
            self._log_validation_metric_values(current_iter, dataset_name)

    def _log_validation_metric_values(self, current_iter, dataset_name):
        log_str = f"Validation {dataset_name}\n"
        for metric, value in self.metric_results.items():
            rec = self.best_metric_results[dataset_name][metric]
            log_str += f"\t # {metric}: {value:.4f}\tBest: {rec['val']:.4f} @ {rec['iter']} iter\n"
        get_root_logger().info(log_str)
