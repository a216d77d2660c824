"""Host-side helpers: seeding, time strings, directories, resume rewiring (dcpt_tpu/utils/misc.py)."""

from __future__ import annotations

import os
import os.path as osp
import random
import time

import numpy as np


def set_random_seed(seed: int) -> None:
    """Seed python, numpy and torch (reference: misc.py:13-20)."""
    import torch

    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def get_time_str() -> str:
    return time.strftime("%Y%m%d_%H%M%S", time.localtime())


def mkdir_and_rename(path: str) -> None:
    """mkdir; if it exists, rename the old one with a timestamp."""
    if osp.exists(path):
        new_name = path + "_archived_" + get_time_str()
        print(f"Path already exists. Rename it to {new_name}", flush=True)
        os.rename(path, new_name)
    os.makedirs(path, exist_ok=True)


def make_exp_dirs(opt: dict) -> None:
    """Create the experiments (training) or results (eval) directory layout (reference: misc.py:40-57)."""
    path_opt = dict(opt["path"])
    mkdir_and_rename(path_opt.pop("experiments_root" if opt.get("is_train") else "results_root"))
    for key, path in path_opt.items():
        if ("strict_load" in key) or ("pretrain_network" in key) or ("resume" in key) or ("param_key" in key):
            continue
        if path:
            os.makedirs(path, exist_ok=True)


def check_resume(opt: dict, resume_iter: int, frozen: tuple[str, ...] = ()) -> None:
    """When resuming, point every ``pretrain_network_*`` at the run's own
    ``net_*_<iter>.pth`` and load raw params rather than an EMA (reference:
    misc.py:102-137).  The nets in ``frozen`` (the model's ``FROZEN_NETWORKS``:
    the probe's ``net_g``, the fine-tune's ``net_dc``, which their models never
    save) keep their configured path and param key; dcpt_tpu points them at a
    snapshot that is not there, and its probe and fine-tune cannot resume.  A
    trained net whose snapshot at ``resume_iter`` is missing raises."""
    if not opt["path"].get("resume_state"):
        return
    networks = [key for key in opt if key.startswith("network_")]
    if any(opt["path"].get(f"pretrain_{network}") is not None for network in networks):
        print("pretrain_network path will be ignored during resuming.", flush=True)
    ignore = opt["path"].get("ignore_resume_networks") or ()
    for network in (n for n in networks if n not in ignore and n not in frozen):
        name, label = f"pretrain_{network}", network.replace("network_", "")
        path = osp.join(opt["path"]["models"], f"net_{label}_{resume_iter}.pth")
        if not osp.exists(path):
            raise FileNotFoundError(f"cannot resume {network}: the run trains it and its snapshot {path} is missing")
        opt["path"][name] = path
        print(f"Set {name} to {path}", flush=True)
    kept = {f"param_key_{n.replace('network_', '')}" for n in frozen}
    for param_key in [key for key in opt["path"] if key.startswith("param_key") and key not in kept]:
        if opt["path"][param_key] == "params_ema":
            opt["path"][param_key] = "params"
            print(f"Set {param_key} to params", flush=True)
