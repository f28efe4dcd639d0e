"""Logging setup — the counterpart of `image_matching_tpu/utils/logging.py`
(without its optional `coloredlogs`) — and the training CLIs' optional
tensorboardX writer."""
from __future__ import annotations

import logging


def get_logger(name: str = "image_matching_tpu_torch", level: int = logging.INFO) -> logging.Logger:
    """A logger that writes `[time level name] message` lines to stderr,
    set up once per name."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter("[%(asctime)s %(levelname)s %(name)s] %(message)s", "%H:%M:%S"))
        logger.addHandler(handler)
        logger.setLevel(level)
    return logger


def summary_writer(run_dir: str):
    """A tensorboardX `SummaryWriter` on `<run_dir>/logdir` where the package
    is installed, else None."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(f"{run_dir}/logdir")
