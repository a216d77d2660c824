"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch twin.

``DCPT_TPU_PALLAS`` is read once, at import, with dcpt_tpu's meaning
(``dcpt_tpu/ops/__init__.py``): ``1`` is the ``all`` mode, which turns on the
opt-in c = 512 NAFBlock fusions (K4 ``naf_prefix`` and K5 ``naf_ffn``) on the
NAFBlock's module path (``DCPT_TPU_NAF_BLOCK=0``).  ``auto`` (the default) and
``0`` leave the port's routes as they are: the port keeps one switch per
kernel, so ``0`` is no kill switch here.  ``enable_kernels`` sets the mode
after import (tests flip it there, never the environment).

dcpt_tpu's public ops API (``dcpt_tpu/ops/__init__.py``) that no net of
dcpt_tpu calls is exported under its names: ``window_partition_fused`` and
``window_reverse_fused`` (K11), ``fused_bias_leaky_relu`` (K12),
``mdta_attention`` (K13), ``fused_ln_proj`` (K14) and ``naf_expand`` (K5').
Each launches its CUDA kernel on a CUDA tensor or raises, and runs its plain
version on a CPU tensor; no net of the port calls them either.
"""

import os

_MODE_BY_ENV = {"0": "off", "1": "all", "auto": "auto"}
_KERNEL_MODE = _MODE_BY_ENV.get(os.environ.get("DCPT_TPU_PALLAS", "auto"), "auto")


def kernel_mode() -> str:
    """``off``, ``auto`` or ``all``."""
    return _KERNEL_MODE


def enable_kernels(mode: str = "all") -> None:
    """Set the mode: ``off``, ``auto`` or ``all``."""
    global _KERNEL_MODE
    if mode not in ("off", "auto", "all"):
        raise ValueError(f"enable_kernels: mode must be off, auto or all, got {mode!r}")
    _KERNEL_MODE = mode


from .fused_act import fused_bias_leaky_relu  # noqa: E402
from .ln_proj import fused_ln_proj  # noqa: E402
from .mdta import mdta_attention  # noqa: E402
from .naf_ffn import naf_expand  # noqa: E402
from .window_process import window_partition_fused, window_reverse_fused  # noqa: E402

__all__ = [
    "kernel_mode",
    "enable_kernels",
    "fused_bias_leaky_relu",
    "fused_ln_proj",
    "mdta_attention",
    "naf_expand",
    "window_partition_fused",
    "window_reverse_fused",
]
