"""dcpt_tpu's flax parameters -> this package's PyTorch state dict.

The inverse of ``dcpt_tpu/convert/torch_checkpoint.py``: ``translate_tensor``'s
layout rules (HWIO kernel -> OIHW weight, (I, O) -> (O, I), (1, 1, 1, C) ->
(1, C, 1, 1)) and each arch's ``torch_key_map`` renames.  Takes the nested
dict of numpy arrays that ``state_dict_to_params`` returns (optionally under a
``params`` key) and imports neither JAX nor dcpt_tpu.  ``load_tree_npz``
reads dcpt_tpu's ``.npz`` network snapshots into such trees.
"""

from __future__ import annotations

import re

import numpy as np
import torch

# flax module path -> reference torch module path, per arch (inverse of
# dcpt_tpu/archs/nafnet_arch.py::_NAFNET_RENAMES)
_NAFNET_INVERSE = [
    (re.compile(r"^encoders_(\d+)_(\d+)\."), r"encoders.\1.\2."),
    (re.compile(r"^middle_blks_(\d+)\."), r"middle_blks.\1."),
    (re.compile(r"^downs_(\d+)\."), r"downs.\1."),
    (re.compile(r"^ups_(\d+)\."), r"ups.\1.0."),
    (re.compile(r"^decoder_(\d+)_(\d+)\."), r"decoder\1.\2."),
    (re.compile(r"\.sca_1\."), r".sca.1."),
]
# inverse of dcpt_tpu/archs/degrad_classify_arch.py::_DC_RENAMES
_DC_INVERSE = [
    (re.compile(r"^conv_embed_(\d+)\."), r"conv_embed.\1."),
    (re.compile(r"^bottleneck_layers_(\d+)_(\d+)\."), r"bottleneck_layers.\1.\2."),
    (re.compile(r"^last_stage_(\d+)\."), r"last_stage.\1."),
    (re.compile(r"^downsample_layers_(\d+)\."), r"downsample_layers.\1.0."),
    (re.compile(r"\.(conv1|conv2|conv3|shortcut)_norm\."), r".\1.norm."),
]
# inverse of dcpt_tpu/archs/restormer_arch.py::_COMMON_RENAMES (and the same
# renames in promptir_arch.py::_PROMPTIR_RENAMES); the level rename comes first
_RESTORMER_COMMON = [
    (re.compile(r"\.(norm1|norm2)\.(weight|bias)$"), r".\1.body.\2"),
    (re.compile(r"^(down\d_\d|up\d_\d)\."), r"\1.body.0."),
    (re.compile(r"^patch_embed\."), r"patch_embed.proj."),
    (re.compile(r"^output_(\d+)\."), r"output.\1."),
]
_LEVEL = r"^(encoder_level\d|latent|decoder_level\d|refinement)_(\d+)\."
_RESTORMER_INVERSE = [(re.compile(_LEVEL), r"\1.body.\2."), *_RESTORMER_COMMON]  # inverse of _SEQ_BODY
_PLAIN_LEVELS_INVERSE = [(re.compile(_LEVEL), r"\1.\2."), *_RESTORMER_COMMON]  # of _SEQ_PLAIN, PromptIR's levels
# inverse of dcpt_tpu/archs/swinir_arch.py::torch_key_map (upsample.{2n} holds the
# n-th upsampling conv; the PixelShuffles between them hold no parameters)
_SWINIR_INVERSE = [
    (re.compile(r"^encode_layers_(\d+)\."), r"encode_layers.\1."),
    (re.compile(r"^decode_layers_(\d+)\."), r"decode_layers\1."),
    (re.compile(r"\.residual_group_blocks_(\d+)\."), r".residual_group.blocks.\1."),
    (re.compile(r"\.conv_(\d+)\."), r".conv.\1."),  # the 3conv bottleneck
    (re.compile(r"^patch_embed_norm\."), r"patch_embed.norm."),
    (re.compile(r"^conv_before_upsample_0\."), r"conv_before_upsample.0."),
    (re.compile(r"^upsample_conv(\d+)\."), lambda m: f"upsample.{2 * int(m.group(1))}."),
]
INVERSE_KEY_MAPS = {"NAFNetBaseline": _NAFNET_INVERSE, "PromptIR_DC": _DC_INVERSE, "PromptIR_NoImg_DC": _DC_INVERSE,
                    "Restormer": _RESTORMER_INVERSE, "Restormer_origin": _PLAIN_LEVELS_INVERSE,
                    "PromptIR": _PLAIN_LEVELS_INVERSE, "SwinIR": _SWINIR_INVERSE}


def _flatten(tree: dict, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _translate(leaf: str, value: np.ndarray) -> tuple[str, np.ndarray]:
    """One flax leaf -> (torch leaf name, torch layout)."""
    if leaf == "kernel":
        if value.ndim == 4:
            return "weight", value.transpose(3, 2, 0, 1)
        if value.ndim == 2:
            return "weight", value.transpose(1, 0)
        raise ValueError(f"unexpected kernel of rank {value.ndim}")
    if value.ndim == 4 and value.shape[:3] == (1, 1, 1):
        return leaf, value.transpose(0, 3, 1, 2)  # beta / gamma residual scales
    return leaf, value


def params_to_state_dict(params: dict, arch: str) -> dict[str, torch.Tensor]:
    """Flax params of ``arch`` (e.g. ``"NAFNetBaseline"``) -> a PyTorch state dict."""
    if set(params) == {"params"}:
        params = params["params"]
    renames = INVERSE_KEY_MAPS[arch]
    state = {}
    for path, value in _flatten(params):
        *mod, leaf = path.split(".")
        leaf, value = _translate(leaf, value)
        key = ".".join([*mod, leaf])
        for pat, repl in renames:
            key = pat.sub(repl, key)
        state[key] = torch.from_numpy(np.array(value))  # a writable copy
    return state


def load_tree_npz(path: str) -> dict[str, dict]:
    """A dcpt_tpu ``.npz`` snapshot -> ``{param_key: nested tree}``: its entries
    are ``{param_key}::{flat path}`` with ``/``-joined paths (dcpt_tpu's
    ``utils/tree_io.py::save_tree_npz``)."""
    by_key: dict[str, dict] = {}
    with np.load(path) as data:
        for full_key in data.files:
            param_key, flat_key = full_key.split("::", 1)
            *parents, leaf = flat_key.split("/")
            node = by_key.setdefault(param_key, {})
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = data[full_key]
    return by_key
