"""Logging (dcpt_tpu/utils/logger.py): the root logger, the environment banner,
the training loop's timers and per-iteration message, and TensorBoard."""

from __future__ import annotations

import datetime
import logging
import time

initialized_logger: dict[str, bool] = {}


def get_root_logger(logger_name: str = "dcpt_tpu_torch", log_level: int = logging.INFO, log_file: str | None = None):
    """A named logger writing to stderr and, on first call with ``log_file``, to that file."""
    logger = logging.getLogger(logger_name)
    if logger_name in initialized_logger:
        return logger
    format_str = "%(asctime)s %(levelname)s: %(message)s"
    stream_handler = logging.StreamHandler()
    stream_handler.setFormatter(logging.Formatter(format_str))
    logger.addHandler(stream_handler)
    logger.propagate = False
    logger.setLevel(log_level)
    if log_file is not None:
        file_handler = logging.FileHandler(log_file, "w")
        file_handler.setFormatter(logging.Formatter(format_str))
        file_handler.setLevel(log_level)
        logger.addHandler(file_handler)
    initialized_logger[logger_name] = True
    return logger


def get_env_info() -> str:
    """Environment banner: PyTorch, CUDA and the visible devices."""
    import torch

    msg = "\nVersion Information: "
    msg += f"\n\tPyTorch: {torch.__version__}"
    msg += f"\n\tCUDA: {torch.version.cuda}"
    if torch.cuda.is_available():
        msg += f"\n\tDevices: {[torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]}"
    else:
        msg += "\n\tDevices: cpu"
    return msg


class AvgTimer:
    """Windowed average timer (reference: logger.py:10-41)."""

    def __init__(self, window: int = 200):
        self.window = window
        self.current_time = self.total_time = self.avg_time = 0.0
        self.count = 0
        self.start()

    def start(self) -> None:
        self.start_time = self.tic = time.time()

    def record(self) -> None:
        self.count += 1
        self.toc = time.time()
        self.current_time = self.toc - self.tic
        self.total_time += self.current_time
        self.avg_time = self.total_time / self.count
        if self.count > self.window:
            self.count = 0
            self.total_time = 0
        self.tic = time.time()

    def get_current_time(self) -> float:
        return self.current_time

    def get_avg_time(self) -> float:
        return self.avg_time


class MessageLogger:
    """Format and emit the training log with ETA (reference: logger.py:44-116)."""

    def __init__(self, opt: dict, start_iter: int = 1, tb_logger=None):
        self.exp_name = opt["name"]
        self.start_iter = start_iter
        self.max_iters = opt["train"]["total_iter"]
        self.tb_logger = tb_logger
        self.start_time = time.time()
        self.logger = get_root_logger()

    def reset_start_time(self) -> None:
        self.start_time = time.time()

    def __call__(self, log_vars: dict) -> None:
        current_iter = log_vars.pop("iter")
        epoch = log_vars.pop("epoch")
        lrs = log_vars.pop("lrs")
        message = f"[{self.exp_name[:5]}..][epoch:{epoch:3d}, iter:{current_iter:8,d}, lr:("
        message += "".join(f"{v:.3e}," for v in lrs) + ")] "
        if "time" in log_vars:
            iter_time, data_time = log_vars.pop("time"), log_vars.pop("data_time")
            time_sec_avg = (time.time() - self.start_time) / (current_iter - self.start_iter + 1)
            eta_str = str(datetime.timedelta(seconds=int(time_sec_avg * (self.max_iters - current_iter - 1))))
            message += f"[eta: {eta_str}, time (data): {iter_time:.3f} ({data_time:.3f})] "
        for k, v in log_vars.items():
            message += f"{k}: {v:.4e} "
            if self.tb_logger is not None:
                self.tb_logger.add_scalar(f"losses/{k}" if k.startswith("l_") else k, v, current_iter)
        self.logger.info(message)


def init_tb_logger(log_dir: str):
    """A TensorBoard writer; raises when ``torch.utils.tensorboard`` cannot be imported
    (set ``logger: use_tb_logger: false`` to train without it)."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError as e:
        raise RuntimeError("logger.use_tb_logger is true, but torch.utils.tensorboard cannot be imported "
                           f"({e}); set logger:use_tb_logger=false") from e
    return SummaryWriter(log_dir=log_dir)
