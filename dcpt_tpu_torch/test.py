"""yml-driven test/eval entry point (dcpt_tpu/test.py, reference basicsr/test.py:21-71).

Usage::

    python -m dcpt_tpu_torch.test -opt options/all_in_one/test/test_NAFNet_5d.yml
"""

from __future__ import annotations

import logging
import os
import os.path as osp

from dcpt_tpu_torch.data import build_dataloader, build_dataset
from dcpt_tpu_torch.models import build_model
from dcpt_tpu_torch.utils.logger import get_env_info, get_root_logger
from dcpt_tpu_torch.utils.misc import get_time_str, make_exp_dirs
from dcpt_tpu_torch.utils.options import dict2str, parse_options


def test_pipeline(root_path: str, args=None) -> dict:
    """Evaluate every dataset of the yml; returns ``{dataset name: {metric: value}}``."""
    opt, _ = parse_options(root_path, is_train=False, args=args)

    make_exp_dirs(opt)
    log_file = osp.join(opt["path"]["log"], f"test_{opt['name']}_{get_time_str()}.log")
    logger = get_root_logger(log_level=logging.INFO, log_file=log_file)
    logger.info(get_env_info())
    logger.info(dict2str(opt))

    test_loaders = []
    for _, dataset_opt in sorted(opt["datasets"].items()):
        test_set = build_dataset(dataset_opt)
        test_loaders.append(build_dataloader(test_set, dataset_opt))
        logger.info(f"Number of test images in {dataset_opt['name']}: {len(test_set)}")

    model = build_model(opt)

    results = {}
    for test_loader in test_loaders:
        test_set_name = test_loader.dataset.opt["name"]
        logger.info(f"Testing {test_set_name}...")
        model.validation(test_loader, current_iter=opt["name"], tb_logger=None,
                         save_img=opt["val"].get("save_img", False))
        if hasattr(model, "metric_results"):
            results[test_set_name] = dict(model.metric_results)
    return results


def main() -> None:
    test_pipeline(os.getcwd())


if __name__ == "__main__":
    main()
