"""yml-driven training entry point (dcpt_tpu/train.py).

Usage::

    python -m dcpt_tpu_torch.train -opt options/all_in_one/train/train_NAFNet_dcpt_5d.yml [--auto_resume]

The BasicSR-style loop: resume, the train loader over an EnlargedSampler, the
``val*`` loaders, a prefetcher, then per iteration ``update_learning_rate`` /
``feed_data`` / ``optimize_parameters`` / log / save / validate (every
``val.val_freq`` iterations, and once more after the final save).  DCPT's
multi-degradation training uses ``datasets.train.type: ConcatDataset`` with one
dataset config per degradation, built in sorted key order; the concat stamps
``dataset_idx``, the classification label (a ``val*`` set may be one too: the
probe's top-1 validation reads it).  A SIGTERM (in the main thread) lets the
step in flight finish, then the model and the training state are saved at that
iteration and the run returns; ``--auto_resume`` continues from there
(dcpt_tpu/train.py:185-209, 255-263).  ``num_gpu: 0`` trains on the CPU,
otherwise on the card.  One process.
"""

from __future__ import annotations

import datetime
import logging
import math
import os
import os.path as osp
import signal
import threading
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
from dcpt_tpu_torch.utils.registry import MODEL_REGISTRY


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


def create_train_val_dataloader(opt: dict, logger):
    """The train loader and sampler, the ``val*`` loaders, the epochs and the
    iterations (reference: dcpt_tpu/train.py:73-114); an unknown phase raises."""
    val_loaders = []
    for phase, dataset_opt in opt["datasets"].items():
        if phase.split("_")[0] == "val":
            val_set = _build_train_dataset(dataset_opt)
            val_loaders.append(build_dataloader(val_set, dataset_opt, num_gpu=opt["num_gpu"], seed=opt["manual_seed"]))
            logger.info(f"Number of val images/folders in {dataset_opt['name']}: {len(val_set)}")
        elif phase != "train":
            raise ValueError(f"Dataset phase {phase} is not recognized.")
    dataset_opt = opt["datasets"]["train"]
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
    return loader, sampler, val_loaders, total_epochs, total_iters


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

    train_loader, train_sampler, val_loaders, total_epochs, total_iters = create_train_val_dataloader(opt, logger)

    resume_state = None
    if resume_state_path:
        resume_state = torch.load(resume_state_path, map_location="cpu", weights_only=True)
        # the nets the run trains load from its own snapshots; the frozen ones keep theirs
        check_resume(opt, resume_state["iter"], MODEL_REGISTRY.get(opt["model_type"]).FROZEN_NETWORKS)
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

    # the preemption save: the handler only records the signal, the loop saves after the step in flight
    stop = {"signum": None}
    prev_handler = None
    in_main = threading.current_thread() is threading.main_thread()  # signal handlers bind there only
    if in_main:
        def _request_stop(signum, frame):  # noqa: ARG001
            stop["signum"] = signum

        prev_handler = signal.signal(signal.SIGTERM, _request_stop)
    try:
        return _train_loop(opt, logger, msg_logger, tb_logger, model, train_sampler, train_loader, val_loaders,
                           total_epochs, total_iters, start_epoch, current_iter, prefetch_mode, stop)
    finally:
        if in_main:
            # None: the previous handler was installed from C and cannot be put back from Python
            signal.signal(signal.SIGTERM, prev_handler if prev_handler is not None else signal.SIG_DFL)
        if tb_logger is not None:
            tb_logger.close()


def _validate(opt, model, val_loaders, current_iter, tb_logger) -> None:
    for val_loader in val_loaders:
        model.validation(val_loader, current_iter, tb_logger, opt["val"].get("save_img", False))


def _train_loop(opt, logger, msg_logger, tb_logger, model, train_sampler, train_loader, val_loaders, total_epochs,
                total_iters, start_epoch, current_iter, prefetch_mode, stop):
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
            if opt.get("val") is not None and current_iter % opt["val"]["val_freq"] == 0:
                _validate(opt, model, val_loaders, current_iter, tb_logger)
            if stop["signum"] is not None:
                logger.warning(f"Received signal {stop['signum']}: saving the model and the training state at "
                               f"iteration {current_iter} and returning; resume with --auto_resume.")
                model.save(epoch, current_iter)
                return model
            data_timer.start()
            iter_timer.start()
            train_data = prefetcher.next()
        if current_iter > total_iters:
            break

    logger.info(f"End of training. Time consumed: {datetime.timedelta(seconds=int(time.time() - start_time))}")
    logger.info("Save the latest model.")
    model.save(epoch=-1, current_iter=-1)
    if opt.get("val") is not None:
        _validate(opt, model, val_loaders, current_iter, tb_logger)
    return model


def main() -> None:
    train_pipeline(os.getcwd())


if __name__ == "__main__":
    main()
