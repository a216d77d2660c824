"""Logging (dcpt_tpu/utils/logger.py): the root logger and the environment banner."""

from __future__ import annotations

import logging

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
