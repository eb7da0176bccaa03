"""Text logger of the scripts (port of ``kinpoly_tpu/utils/logger.py``):
timestamped lines to stdout and, given a path, to a file."""

from __future__ import annotations

import logging
import os
import sys


def create_logger(file_path: str | None = None,
                  name: str = "kinpoly_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    for h in logger.handlers:
        h.close()
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)s  %(message)s", "%H:%M:%S")
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if file_path:
        os.makedirs(os.path.dirname(os.path.abspath(file_path)), exist_ok=True)
        fh = logging.FileHandler(file_path)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger
