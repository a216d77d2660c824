"""Arch registry + builder (dcpt_tpu/archs/__init__.py)."""

from copy import deepcopy

from ..utils.registry import ARCH_REGISTRY
from . import degrad_classify_arch, nafnet_arch  # noqa: F401  (register their archs)

__all__ = ["build_network"]


def build_network(opt: dict):
    """Instantiate an arch from its config dict (``type`` + constructor kwargs)."""
    opt = deepcopy(opt)
    return ARCH_REGISTRY.get(opt.pop("type"))(**opt)
