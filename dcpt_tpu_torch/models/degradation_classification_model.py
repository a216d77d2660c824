"""DCModel (dcpt_tpu/models/degradation_classification_model.py), the part that
DCPTModel inherits: both networks, their loading, and the batch.

The stage-2 probe itself (a frozen restoration net, the classifier alone
trained, top-1 validation) is not ported yet and raises.
"""

from __future__ import annotations

from ..archs import build_network
from ..utils.registry import MODEL_REGISTRY
from .base_model import BaseModel


@MODEL_REGISTRY.register()
class DCModel(BaseModel):
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
        raise NotImplementedError("DCModel's probe training is not ported to dcpt_tpu_torch yet (ROADMAP Q1)")

    def feed_data(self, data: dict) -> None:
        self.lq = data["lq"].to(self.device, non_blocking=True)
        self.dataset_idx = data["dataset_idx"].to(self.device, non_blocking=True)
        self.gt = data["gt"].to(self.device, non_blocking=True) if "gt" in data else None
