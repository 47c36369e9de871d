"""Structured logging: the counterpart of :mod:`sparse_matrix_mult_tpu.utils.logging`,
read from the same ``SMM_TPU_LOG`` level variable, so one setting drives both
packages."""

from __future__ import annotations

import logging
import os

_LOGGER_NAME = "sparse_matrix_mult_tpu_torch"


def get_logger() -> logging.Logger:
    logger = logging.getLogger(_LOGGER_NAME)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s")
        )
        logger.addHandler(handler)
        level = os.environ.get("SMM_TPU_LOG", "WARNING").upper()
        logger.setLevel(getattr(logging, level, logging.WARNING))
    return logger
