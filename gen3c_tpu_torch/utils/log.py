"""Process-aware logging on the standard library (rank from $RANK)."""

from __future__ import annotations

import logging
import os
import sys

_LOGGER = None


def _rank() -> int:
    return int(os.environ.get("RANK", "0"))


def get_logger() -> logging.Logger:
    global _LOGGER
    if _LOGGER is None:
        logger = logging.getLogger("gen3c_tpu_torch")
        if not logger.handlers:
            handler = logging.StreamHandler(sys.stdout)
            handler.setFormatter(
                logging.Formatter(
                    "[%(asctime)s %(levelname)s %(name)s] %(message)s",
                    datefmt="%H:%M:%S",
                )
            )
            logger.addHandler(handler)
            logger.setLevel(os.environ.get("GEN3C_LOG_LEVEL", "INFO"))
            logger.propagate = False
        _LOGGER = logger
    return _LOGGER


def info(msg: str, rank0_only: bool = True) -> None:
    if not rank0_only or _rank() == 0:
        get_logger().info(msg)


def warning(msg: str, rank0_only: bool = True) -> None:
    if not rank0_only or _rank() == 0:
        get_logger().warning(msg)



def error(msg: str, rank0_only: bool = True) -> None:
    if not rank0_only or _rank() == 0:
        get_logger().error(msg)


def debug(msg: str, rank0_only: bool = True) -> None:
    if not rank0_only or _rank() == 0:
        get_logger().debug(msg)
