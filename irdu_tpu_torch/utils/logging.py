"""Named loggers with a stream and an optional file handler, each name set
up once (a copy of ``irdu_tpu/utils/logging.py``, same line format)."""

from __future__ import annotations

import logging

_LOGGERS: dict[str, logging.Logger] = {}


def get_root_logger(logger_name: str = "irdu", log_level: int = logging.INFO,
                    log_file: str | None = None) -> logging.Logger:
    """The logger ``logger_name``, made on the first call (later calls return
    it as it is, without adding handlers)."""
    if logger_name in _LOGGERS:
        return _LOGGERS[logger_name]
    logger = logging.getLogger(logger_name)
    logger.setLevel(log_level)
    logger.propagate = False
    fmt = logging.Formatter("%(asctime)s %(levelname)s: %(message)s")
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_file:
        fh = logging.FileHandler(log_file, "a")
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    _LOGGERS[logger_name] = logger
    return logger
