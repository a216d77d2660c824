"""BaseModel, eval half (dcpt_tpu/models/base_model.py): device, loading, validation bookkeeping."""

from __future__ import annotations

import torch

from ..utils.logger import get_root_logger


class BaseModel:
    def __init__(self, opt: dict):
        self.opt = opt
        # num_gpu 0 is the CPU; parse_options has already refused CUDA requests without a device
        self.device = torch.device("cuda" if opt["num_gpu"] != 0 else "cpu")

    def validation(self, dataloader, current_iter, tb_logger, save_img=False):
        self.nondist_validation(dataloader, current_iter, tb_logger, save_img)

    def _initialize_best_metric_results(self, dataset_name: str) -> None:
        """Track the best value of each metric per dataset (reference: base_model.py:58-76)."""
        if hasattr(self, "best_metric_results") and dataset_name in self.best_metric_results:
            return
        if not hasattr(self, "best_metric_results"):
            self.best_metric_results = {}
        record = {}
        for metric, content in self.opt["val"]["metrics"].items():
            better = content.get("better", "higher")
            record[metric] = dict(better=better, val=float("-inf") if better == "higher" else float("inf"), iter=-1)
        self.best_metric_results[dataset_name] = record

    def _update_best_metric_result(self, dataset_name, metric, val, current_iter) -> None:
        rec = self.best_metric_results[dataset_name][metric]
        if (rec["better"] == "higher" and val >= rec["val"]) or (rec["better"] == "lower" and val <= rec["val"]):
            rec["val"] = val
            rec["iter"] = current_iter

    def load_network(self, net: torch.nn.Module, load_path: str, strict: bool = True, param_key: str | None = "params") -> None:
        """Load a reference ``.pth`` (``{param_key: state_dict}``) into ``net``,
        falling back from a missing ``params_ema`` to ``params`` and dropping a
        DDP ``module.`` prefix (reference: base_model.py:300-369)."""
        logger = get_root_logger()
        load_net = torch.load(load_path, map_location="cpu", weights_only=True)
        if param_key is not None:
            if param_key not in load_net and "params" in load_net:
                param_key = "params"
                logger.info("Loading: params_ema does not exist, use params.")
            load_net = load_net[param_key]
        logger.info(f"Loading {net.__class__.__name__} model from {load_path}, with param key: [{param_key}].")
        load_net = {(k[len("module."):] if k.startswith("module.") else k): v for k, v in load_net.items()}
        net.load_state_dict(load_net, strict=strict)

    def print_network(self, net: torch.nn.Module) -> None:
        n_params = sum(p.numel() for p in net.parameters())
        get_root_logger().info(f"Network: {net.__class__.__name__}, with parameters: {n_params:,d}")
