"""Loss registry + builder (dcpt_tpu/losses/__init__.py)."""

from copy import deepcopy

from ..utils.logger import get_root_logger
from ..utils.registry import LOSS_REGISTRY
from .basic_loss import CrossEntropyLoss, L1Loss, MSELoss, PSNRLoss  # noqa: F401  (registers the losses)

__all__ = ["build_loss"]


def build_loss(opt: dict):
    opt = deepcopy(opt)
    loss = LOSS_REGISTRY.get(opt.pop("type"))(**opt)
    get_root_logger().info(f"Loss [{loss.__class__.__name__}] is created.")
    return loss
