"""Model registry + builder (dcpt_tpu/models/__init__.py)."""

from copy import deepcopy

from ..utils.logger import get_root_logger
from ..utils.registry import MODEL_REGISTRY
from . import (  # noqa: F401  (register the models)
    degradation_classification_distillation_model,
    degradation_classification_model,
    degradation_classification_pretrain_model,
    sr_model,
)

__all__ = ["build_model"]


def build_model(opt: dict):
    opt = deepcopy(opt)
    model = MODEL_REGISTRY.get(opt["model_type"])(opt)
    get_root_logger().info(f"Model [{model.__class__.__name__}] is created.")
    return model
