"""Host-side helpers: seeding, time strings, directories (dcpt_tpu/utils/misc.py)."""

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
    """Create the results directory layout of an eval run."""
    path_opt = dict(opt["path"])
    mkdir_and_rename(path_opt.pop("results_root"))
    for key, path in path_opt.items():
        if ("strict_load" in key) or ("pretrain_network" in key) or ("resume" in key) or ("param_key" in key):
            continue
        if path:
            os.makedirs(path, exist_ok=True)

