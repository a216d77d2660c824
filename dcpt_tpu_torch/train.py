"""yml-driven training entry point (dcpt_tpu/train.py).

Usage::

    python -m dcpt_tpu_torch.train -opt options/all_in_one/train/train_NAFNet_dcpt_5d.yml [--auto_resume]

The BasicSR-style loop: resume, the train loader over an EnlargedSampler, a
prefetcher, then per iteration ``update_learning_rate`` / ``feed_data`` /
``optimize_parameters`` / log / save.  DCPT's multi-degradation training uses
``datasets.train.type: ConcatDataset`` with one dataset config per
degradation, built in sorted key order; the concat stamps ``dataset_idx``, the
classification label.  ``num_gpu: 0`` trains on the CPU, otherwise on the
card.  One process.  dcpt_tpu's SIGTERM preemption save and validation inside
the loop are not ported yet: a yml with a ``val`` section raises.
"""

from __future__ import annotations

import datetime
import logging
import math
import os
import os.path as osp
import time

import torch

from dcpt_tpu_torch.data import (
    ConcatDataset,
    CPUPrefetcher,
    CUDAPrefetcher,
    EnlargedSampler,
    build_dataloader,
    build_dataset,
)
from dcpt_tpu_torch.models import build_model
from dcpt_tpu_torch.utils.logger import AvgTimer, MessageLogger, get_env_info, get_root_logger, init_tb_logger
from dcpt_tpu_torch.utils.misc import check_resume, get_time_str, make_exp_dirs, mkdir_and_rename
from dcpt_tpu_torch.utils.options import copy_opt_file, dict2str, parse_options


def _build_train_dataset(dataset_opt: dict):
    """A plain dataset, or a ConcatDataset of the per-degradation datasets in sorted key order."""
    if dataset_opt.get("type") != "ConcatDataset":
        return build_dataset(dataset_opt)
    subs, ratios = [], []
    for _, sub_opt in sorted(dataset_opt["datasets"].items()):
        sub_opt = dict(sub_opt)
        for inherited in ("phase", "scale", "gt_size", "use_hflip", "use_rot"):
            if inherited in dataset_opt and inherited not in sub_opt:
                sub_opt[inherited] = dataset_opt[inherited]
        ratios.append(sub_opt.pop("enlarge_ratio", 1))
        subs.append(build_dataset(sub_opt))
    ds = ConcatDataset(subs, enlarge_ratios=ratios)
    ds.opt = dataset_opt
    return ds


def create_train_dataloader(opt: dict, logger):
    dataset_opt = opt["datasets"]["train"]
    unknown = [phase for phase in opt["datasets"] if phase != "train"]
    if unknown or opt.get("val") is not None:
        raise NotImplementedError(f"validation inside the training loop is not ported to dcpt_tpu_torch yet "
                                  f"(datasets {unknown}, val: {opt.get('val') is not None})")
    ratio = dataset_opt.get("dataset_enlarge_ratio", 1)
    train_set = _build_train_dataset(dataset_opt)
    sampler = EnlargedSampler(train_set, opt["world_size"], opt["rank"], ratio,
                              torch_compat=bool(dataset_opt.get("torch_compat_sampler", False)))
    loader = build_dataloader(train_set, dataset_opt, num_gpu=opt["num_gpu"], sampler=sampler,
                              seed=opt["manual_seed"], pin_memory=opt["num_gpu"] != 0)
    iters_per_epoch = math.ceil(len(train_set) * ratio / (dataset_opt["batch_size_per_gpu"] * opt["world_size"]))
    total_iters = int(opt["train"]["total_iter"])
    total_epochs = math.ceil(total_iters / iters_per_epoch)
    logger.info("Training statistics:"
                f"\n\tNumber of train images: {len(train_set)}"
                f"\n\tDataset enlarge ratio: {ratio}"
                f"\n\tBatch size per device: {dataset_opt['batch_size_per_gpu']}"
                f"\n\tWorld size: {opt['world_size']}"
                f"\n\tRequire iter number per epoch: {iters_per_epoch}"
                f"\n\tTotal epochs: {total_epochs}; iters: {total_iters}.")
    return loader, sampler, total_epochs, total_iters


def load_resume_state(opt: dict):
    """The training state to resume from: the newest in training_states with
    ``--auto_resume``, else ``path.resume_state``, else None."""
    if opt["auto_resume"]:
        state_dir = opt["path"]["training_states"]
        states = [v for v in os.listdir(state_dir) if v.endswith(".state")] if osp.isdir(state_dir) else []
        if not states:
            return None
        latest = max(int(v.split(".state")[0]) for v in states)
        opt["path"]["resume_state"] = osp.join(state_dir, f"{latest}.state")
    return opt["path"].get("resume_state")


def train_pipeline(root_path: str, args=None):
    """Train as the yml says; returns the model."""
    # cuDNN times its convolution algorithms for each new shape, as the reference's entry points do
    torch.backends.cudnn.benchmark = True
    opt, parsed_args = parse_options(root_path, is_train=True, args=args)
    opt["root_path"] = root_path
    use_tb = opt["logger"].get("use_tb_logger")

    resume_state_path = load_resume_state(opt)
    if resume_state_path is None:
        make_exp_dirs(opt)
        if use_tb:
            mkdir_and_rename(osp.join(root_path, "tb_logger", opt["name"]))
    copy_opt_file(parsed_args.opt, opt["path"]["experiments_root"])

    log_file = osp.join(opt["path"]["log"], f"train_{opt['name']}_{get_time_str()}.log")
    logger = get_root_logger(log_level=logging.INFO, log_file=log_file)
    logger.info(get_env_info())
    logger.info(dict2str(opt))
    tb_logger = init_tb_logger(osp.join(root_path, "tb_logger", opt["name"])) if use_tb else None

    train_loader, train_sampler, total_epochs, total_iters = create_train_dataloader(opt, logger)

    resume_state = None
    if resume_state_path:
        resume_state = torch.load(resume_state_path, map_location="cpu", weights_only=True)
        check_resume(opt, resume_state["iter"])  # the nets load from the run's own snapshots
    model = build_model(opt)
    if resume_state:
        model.resume_training(resume_state)
        logger.info(f"Resuming training from epoch: {resume_state['epoch']}, iter: {resume_state['iter']}.")
        start_epoch, current_iter = int(resume_state["epoch"]), int(resume_state["iter"])
    else:
        start_epoch, current_iter = 0, 0

    msg_logger = MessageLogger(opt, current_iter + 1, tb_logger)
    prefetch_mode = (opt["datasets"]["train"].get("prefetch_mode") or "cpu").lower()
    if prefetch_mode in ("device", "cuda") and model.device.type != "cuda":
        prefetch_mode = "cpu"  # a CPU run has no device to copy to
    logger.info(f"Use {prefetch_mode} prefetcher")
    try:
        return _train_loop(opt, logger, msg_logger, model, train_sampler, train_loader, total_epochs, total_iters,
                           start_epoch, current_iter, prefetch_mode)
    finally:
        if tb_logger is not None:
            tb_logger.close()


def _train_loop(opt, logger, msg_logger, model, train_sampler, train_loader, total_epochs, total_iters,
                start_epoch, current_iter, prefetch_mode):
    data_timer, iter_timer = AvgTimer(), AvgTimer()
    start_time = time.time()
    epoch = start_epoch
    for epoch in range(start_epoch, total_epochs + 1):
        train_sampler.set_epoch(epoch)
        if prefetch_mode in ("device", "cuda"):
            prefetcher = CUDAPrefetcher(train_loader, model.device)
        else:
            prefetcher = CPUPrefetcher(train_loader)
        train_data = prefetcher.next()
        while train_data is not None:
            data_timer.record()
            current_iter += 1
            if current_iter > total_iters:
                break
            model.update_learning_rate(current_iter)
            model.feed_data(train_data)
            model.optimize_parameters(current_iter)
            iter_timer.record()
            if current_iter == 1:
                msg_logger.reset_start_time()
            if current_iter % opt["logger"]["print_freq"] == 0:
                log_vars = {"epoch": epoch, "iter": current_iter, "lrs": model.get_current_learning_rate(),
                            "time": iter_timer.get_avg_time(), "data_time": data_timer.get_avg_time()}
                log_vars.update(model.get_current_log())
                msg_logger(log_vars)
            if current_iter % opt["logger"]["save_checkpoint_freq"] == 0:
                logger.info("Saving models and training states.")
                model.save(epoch, current_iter)
            data_timer.start()
            iter_timer.start()
            train_data = prefetcher.next()
        if current_iter > total_iters:
            break

    logger.info(f"End of training. Time consumed: {datetime.timedelta(seconds=int(time.time() - start_time))}")
    logger.info("Save the latest model.")
    model.save(epoch=-1, current_iter=-1)
    return model


def main() -> None:
    train_pipeline(os.getcwd())


if __name__ == "__main__":
    main()
