"""Name -> object registries: the plugin mechanism (dcpt_tpu/utils/registry.py).

Five registries (dataset / arch / model / loss / metric), decorator
registration, duplicate-name rejection, and the suffix fallback on lookup so
configs written for the reference resolve unchanged.
"""

from __future__ import annotations

from typing import Any, Callable


class Registry:
    """A name -> class/function map supporting decorator registration."""

    def __init__(self, name: str):
        self._name = name
        self._obj_map: dict[str, Any] = {}

    def _do_register(self, name: str, obj: Any, suffix: str | None = None) -> None:
        if isinstance(suffix, str):
            name = name + "_" + suffix
        if name in self._obj_map:
            raise KeyError(f"An object named '{name}' was already registered in '{self._name}' registry!")
        self._obj_map[name] = obj

    def register(self, obj: Any = None, suffix: str | None = None) -> Callable | None:
        """Register ``obj`` (or return a class/function decorator when obj is None)."""
        if obj is None:

            def deco(func_or_class: Any) -> Any:
                self._do_register(func_or_class.__name__, func_or_class, suffix)
                return func_or_class

            return deco

        self._do_register(obj.__name__, obj, suffix)
        return None

    def get(self, name: str, suffix: str = "dcpt_tpu") -> Any:
        """Look up ``name``; falls back to ``name_<suffix>`` and ``name_basicsr``."""
        ret = self._obj_map.get(name)
        if ret is None:
            ret = self._obj_map.get(name + "_" + suffix)
        if ret is None:
            ret = self._obj_map.get(name + "_basicsr")
        if ret is None:
            raise KeyError(f"No object named '{name}' found in '{self._name}' registry!")
        return ret


DATASET_REGISTRY = Registry("dataset")
ARCH_REGISTRY = Registry("arch")
MODEL_REGISTRY = Registry("model")
LOSS_REGISTRY = Registry("loss")
METRIC_REGISTRY = Registry("metric")
