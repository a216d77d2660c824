"""Arch registry + builder (dcpt_tpu/archs/__init__.py)."""

import inspect
from copy import deepcopy

from torch import nn

from ..utils.logger import get_root_logger
from ..utils.registry import ARCH_REGISTRY
from . import degrad_classify_arch, nafnet_arch, promptir_arch, restormer_arch, swinir_arch  # noqa: F401  (register)

__all__ = ["build_network"]


def _constructor_keys(cls) -> set[str] | None:
    """The keyword arguments ``cls(...)`` takes, following ``**kwargs`` up the
    class hierarchy to nn.Module; None when it takes any keyword."""
    keys: set[str] = set()
    for klass in cls.__mro__:
        if klass is nn.Module:
            return keys
        if "__init__" not in klass.__dict__:
            continue
        params = inspect.signature(klass.__dict__["__init__"]).parameters.values()
        keys |= {p.name for p in params if p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)} - {"self"}
        if not any(p.kind == p.VAR_KEYWORD for p in params):
            return keys
    return None


def build_network(opt: dict):
    """Instantiate an arch from its config dict (``type`` + constructor kwargs).

    As dcpt_tpu does, keys the arch does not take (reference-config keys such
    as SwinIR's ``h``) are dropped with a warning, ``name`` silently."""
    opt = deepcopy(opt)
    network_type = opt.pop("type")
    cls = ARCH_REGISTRY.get(network_type)
    known = _constructor_keys(cls)
    if known is not None:
        dropped = sorted(set(opt) - known - {"name"})
        if dropped:
            get_root_logger().warning(f"build_network({network_type}): ignoring unknown keys {dropped}")
        opt = {k: v for k, v in opt.items() if k in known}
    return cls(**opt)
