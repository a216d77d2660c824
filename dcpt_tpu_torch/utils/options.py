"""YAML-driven run configuration (dcpt_tpu/utils/options.py).

The config-key surface of the reference harness: ``-opt`` path to a yml
file, ``--force_yml a:b:c=value`` nested overrides and ``--auto_resume``;
``datasets.<phase>`` dicts get ``phase`` / ``scale`` stamped onto
them; a training run's outputs go to ``<root>/experiments/<name>`` (models,
training_states), an eval run's to ``<root>/results/<name>``.  One process:
rank 0 of world size 1.  The yml is read by the port's own loader
(``yaml_lite``).

``num_gpu: 0`` runs on the CPU; ``num_gpu >= 1`` or ``auto`` runs on CUDA and
raises when no CUDA device is present.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import random
from typing import Any

from . import yaml_lite


def yaml_load(path: str):
    """Load a yml file."""
    with open(path, "r") as fh:
        return yaml_lite.loads(fh.read())


def dict2str(opt: dict, indent_level: int = 1) -> str:
    """Pretty-print a nested options dict."""
    msg = "\n"
    for k, v in opt.items():
        if isinstance(v, dict):
            msg += " " * (indent_level * 2) + k + ":["
            msg += dict2str(v, indent_level + 1)
            msg += " " * (indent_level * 2) + "]\n"
        else:
            msg += " " * (indent_level * 2) + f"{k}: {v}\n"
    return msg


def _postprocess_yml_value(value: str) -> Any:
    """Parse a CLI-override string into a typed python value (reference: options.py:76-97)."""
    if value == "~" or value.lower() == "none":
        return None
    if value.lower() == "true":
        return True
    if value.lower() == "false":
        return False
    if value.startswith("!!float"):
        return float(value.replace("!!float", ""))
    if value.isdigit():
        return int(value)
    if value.replace("-", "", 1).isdigit() and value.count("-") == 1 and value.startswith("-"):
        return int(value)
    try:
        return float(value)
    except ValueError:
        pass
    if value.startswith("["):
        return yaml_lite.loads(f"v: {value}")["v"]
    return value


def set_nested(d: dict, keys: list[str], value: Any) -> None:
    for k in keys[:-1]:
        d = d.setdefault(k, {})
    d[keys[-1]] = value


def apply_force_yml(opt: dict, force_entries) -> None:
    """Apply ``a:b:c=value`` overrides."""
    for entry in force_entries or ():
        entry = entry.replace(" ", "")
        keys, value = entry.split("=", 1)
        set_nested(opt, keys.split(":"), _postprocess_yml_value(value))


def resolve_num_gpu(opt: dict) -> None:
    """``num_gpu`` -> a device count; 0 is the CPU.  Asking for CUDA without a
    CUDA device raises: a run never carries on on the CPU instead."""
    import torch

    num = opt.get("num_gpu", "auto")
    if num == 0:
        return
    if not torch.cuda.is_available():
        raise RuntimeError(f"num_gpu: {num} asks for CUDA, but no CUDA device is available "
                           "(set num_gpu: 0 to run on the CPU)")
    opt["num_gpu"] = torch.cuda.device_count() if num == "auto" else int(num)


def parse_options(root_path: str, is_train: bool = False, args: list[str] | None = None) -> tuple[dict, argparse.Namespace]:
    """CLI + yml -> options dict (reference: options.py:100-205), single process."""
    parser = argparse.ArgumentParser()
    parser.add_argument("-opt", type=str, required=True, help="Path to option YAML file.")
    parser.add_argument("--auto_resume", action="store_true")
    parser.add_argument(
        "--force_yml", nargs="+", default=None, help="Force to update yml files. Examples: train:ema_decay=0.999"
    )
    parsed = parser.parse_args(args)

    opt = yaml_load(parsed.opt)
    opt["dist"], opt["rank"], opt["world_size"] = False, 0, 1

    seed = opt.get("manual_seed")
    if seed is None:
        seed = random.randint(1, 10000)
        opt["manual_seed"] = seed
    from .misc import set_random_seed

    set_random_seed(seed)

    apply_force_yml(opt, parsed.force_yml)
    opt["auto_resume"] = parsed.auto_resume
    opt["is_train"] = is_train
    resolve_num_gpu(opt)

    for phase, dataset in (opt.get("datasets") or {}).items():
        dataset["phase"] = phase.split("_")[0]
        if "scale" in opt:
            dataset["scale"] = opt["scale"]
        for key in ("dataroot_gt", "dataroot_lq"):
            if dataset.get(key) is not None:
                dataset[key] = osp.expanduser(dataset[key])

    opt.setdefault("path", {})
    for key, val in opt["path"].items():
        if val and ("resume_state" in key or "pretrain_network" in key):
            opt["path"][key] = osp.expanduser(val)

    if is_train:
        experiments_root = osp.join(root_path, "experiments", opt["name"])
        opt["path"]["experiments_root"] = experiments_root
        opt["path"]["models"] = osp.join(experiments_root, "models")
        opt["path"]["training_states"] = osp.join(experiments_root, "training_states")
        opt["path"]["log"] = experiments_root
        opt["path"]["visualization"] = osp.join(experiments_root, "visualization")
    else:
        results_root = osp.join(root_path, "results", opt["name"])
        opt["path"]["results_root"] = results_root
        opt["path"]["log"] = results_root
        opt["path"]["visualization"] = osp.join(results_root, "visualization")
    return opt, parsed


def copy_opt_file(opt_file: str, experiments_root: str) -> None:
    """Archive the run's yml beside its outputs, headed by the command line (reference: options.py:208-223)."""
    import shutil
    import sys
    import time

    os.makedirs(experiments_root, exist_ok=True)
    filename = osp.join(experiments_root, osp.basename(opt_file))
    shutil.copyfile(opt_file, filename)
    with open(filename, "r+") as f:
        lines = f.readlines()
        lines.insert(0, f"# GENERATE TIME: {time.asctime()}\n# CMD:\n# {' '.join(sys.argv)}\n\n")
        f.seek(0)
        f.writelines(lines)
