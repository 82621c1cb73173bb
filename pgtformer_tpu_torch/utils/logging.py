"""Logging + experiment tracking (BasicSR ``get_root_logger`` / tb_logger
surface), as the JAX package's ``utils/logging.py``; TensorBoard through
``torch.utils.tensorboard``."""

from __future__ import annotations

import logging
import sys
from typing import Optional

_LOGGER_NAME = "pgtformer_tpu_torch"


def get_root_logger() -> logging.Logger:
    """The package's logger, printing to stdout (the JAX package's optional
    log file has no caller in the port)."""
    logger = logging.getLogger(_LOGGER_NAME)
    if logger.handlers:
        return logger
    logger.setLevel(logging.INFO)
    fmt = logging.Formatter(
        "%(asctime)s %(levelname)s: %(message)s", "%Y-%m-%d %H:%M:%S")
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    return logger


class TBLogger:
    """Thin TensorBoard wrapper: a no-op without a log directory or when
    ``tensorboard`` is not installed."""

    def __init__(self, log_dir: Optional[str]):
        self.writer = None
        if log_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                return
            self.writer = SummaryWriter(log_dir)

    def scalars(self, step: int, metrics: dict):
        if self.writer is None:
            return
        for k, v in metrics.items():
            try:
                self.writer.add_scalar(k, float(v), step)
            except (TypeError, ValueError):
                pass

    def flush(self):
        if self.writer is not None:
            self.writer.flush()

    def close(self):
        if self.writer is not None:
            self.writer.close()
            self.writer = None
