"""Path builders (dcpt_tpu/data/data_util.py): the folder modes of the eval datasets."""

from __future__ import annotations

import os
from os import path as osp


def paired_paths_from_folder(folders, keys, filename_tmpl):
    """Paired paths from two folders, incl. the reference's ``_HR_`` -> ``_LRBI_`` rename (data_util.py:240-294)."""
    if len(folders) != 2 or len(keys) != 2:
        raise ValueError(f"expected two folders and two keys, got {folders} and {keys}")
    input_folder, gt_folder = folders
    input_key, gt_key = keys
    input_paths = os.listdir(input_folder)
    gt_paths = os.listdir(gt_folder)
    if len(input_paths) != len(gt_paths):
        raise ValueError(f"{input_key} and {gt_key} datasets have different number of images: "
                         f"{len(input_paths)}, {len(gt_paths)}.")
    paths = []
    input_paths_set = set(input_paths)
    for gt_path in gt_paths:
        basename, ext = osp.splitext(osp.basename(gt_path))
        input_name = f"{filename_tmpl.format(basename)}{ext}"
        if "_HR_" in input_name:
            input_name = input_name.replace("_HR_", "_LRBI_")
        if input_name not in input_paths_set:
            raise ValueError(f"{input_name} is not in {input_key}_paths.")
        paths.append({f"{input_key}_path": osp.join(input_folder, input_name),
                      f"{gt_key}_path": osp.join(gt_folder, gt_path)})
    return paths


def paths_from_folder(folder):
    """All file paths in a folder (data_util.py:297-310)."""
    return [osp.join(folder, path) for path in os.listdir(folder)]
