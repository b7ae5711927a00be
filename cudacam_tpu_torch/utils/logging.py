"""Leveled logging: the port's copy of ``cudacam_tpu/utils/logging.py``.

Analog of the reference's spdlog wrapper (src/utils/logging.hpp:1-23): DEBUG
statements are level-gated, and the formatter mirrors the reference pattern
``[%H:%M:%S] [thread %t] [%l] [%!]`` (logging.hpp:21) with thread id and
function name. The root logger is ``cudacam_tpu_torch``; ``CUDACAM_TPU_LOG``
sets its level, as in the JAX package.
"""
from __future__ import annotations

import logging
import os
import sys

_FMT = "[%(asctime)s] [thread %(thread)d] [%(levelname)s] [%(funcName)s] %(message)s"
_DATEFMT = "%H:%M:%S"

_ROOT_NAME = "cudacam_tpu_torch"
_initialized = False


def init_logging(level: str | int | None = None) -> None:
    """Initialise the framework logger (reference: Utils::InitializeLogger,
    main.cpp:13 -> logging.hpp:18-22). Idempotent."""
    global _initialized
    logger = logging.getLogger(_ROOT_NAME)
    if _initialized:
        if level is not None:
            logger.setLevel(level if isinstance(level, int) else level.upper())
        return
    if level is None:
        level = os.environ.get("CUDACAM_TPU_LOG", "INFO")
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter(_FMT, datefmt=_DATEFMT))
    logger.addHandler(handler)
    logger.setLevel(level if isinstance(level, int) else str(level).upper())
    logger.propagate = False
    _initialized = True


def get_logger(name: str | None = None) -> logging.Logger:
    init_logging()
    if name:
        return logging.getLogger(f"{_ROOT_NAME}.{name}")
    return logging.getLogger(_ROOT_NAME)
