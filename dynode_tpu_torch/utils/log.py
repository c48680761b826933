"""The ``dynode_tpu_torch`` logger and its configuration.

Port of ``dynode_tpu/utils/log.py``: one process-global logger with
console/file/both output modes and a per-run timestamped logfile. It is
named ``"dynode_tpu_torch"``, so that the JAX package's ``"dynode_tpu"``
logger and this one can both log in one process.
"""

import logging
import os
from datetime import datetime
from typing import Literal

from .custom_log_formatter import CustomLogFormatter

logger = logging.getLogger("dynode_tpu_torch")

_FMT = "%(asctime)s - %(name)s - %(levelname)s - %(funcName)s - %(message)s"


def use_logging(
    level: int = logging.INFO,
    output: Literal["file", "console", "both"] = "console",
    log_path: str = "./logs",
) -> logging.Logger:
    """Configure (and return) the global logger.

    Parameters
    ----------
    level : int
        A ``logging`` level (e.g. ``logging.DEBUG``).
    output : {"file", "console", "both"}
        Where log records go. File output creates ``log_path`` if needed and
        writes a per-run timestamped logfile.
    log_path : str
        Directory for logfiles when file output is requested.
    """
    if output not in ("file", "console", "both"):
        raise ValueError(
            f"output must be one of 'file', 'console', 'both'; got {output!r}"
        )
    logger.setLevel(level)
    logger.handlers.clear()
    formatter = CustomLogFormatter(_FMT)

    if output in ("console", "both"):
        console = logging.StreamHandler()
        console.setLevel(level)
        console.setFormatter(formatter)
        logger.addHandler(console)
    if output in ("file", "both"):
        os.makedirs(log_path, exist_ok=True)
        stamp = datetime.now().strftime("%Y%m%d_%H%M%S")
        fh = logging.FileHandler(
            os.path.join(log_path, f"dynode_tpu_torch_{stamp}.log")
        )
        fh.setLevel(level)
        fh.setFormatter(formatter)
        logger.addHandler(fh)
    return logger


__all__ = ["use_logging", "logger"]
