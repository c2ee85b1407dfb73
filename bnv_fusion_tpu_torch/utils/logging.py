"""Logging and config pretty-printing: copy of
bnv_fusion_tpu/utils/logging.py."""

from __future__ import annotations

import logging
import sys


def get_logger(name: str) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(
            "[%(asctime)s][%(name)s][%(levelname)s] %(message)s"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


def print_config(cfg, file=sys.stderr) -> None:
    """Plain-text config tree."""
    def walk(node, indent=0):
        for k, v in node.items():
            if isinstance(v, dict):
                print(" " * indent + f"{k}:", file=file)
                walk(v, indent + 2)
            else:
                print(" " * indent + f"{k}: {v}", file=file)

    walk(cfg)
