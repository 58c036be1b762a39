"""Logging utilities (counterpart of ``mxnet_tpu/log.py``; reference
``python/mxnet/log.py``): ``get_logger`` with the reference's level-letter
formatter, colored on a terminal."""
from __future__ import annotations

import logging
import sys

__all__ = ["get_logger", "getLogger", "DEBUG", "INFO", "WARNING", "ERROR",
           "NOTSET"]

DEBUG = logging.DEBUG
INFO = logging.INFO
WARNING = logging.WARNING
ERROR = logging.ERROR
NOTSET = logging.NOTSET

PY3 = True


class _Formatter(logging.Formatter):
    """Level letter, optionally in ANSI color (reference log.py:37)."""

    def __init__(self, colored=True):
        self.colored = colored
        super().__init__()

    @staticmethod
    def _color(level):
        if level == logging.WARNING:
            return "\x1b[0;33m%s\x1b[0m"
        if level == logging.ERROR:
            return "\x1b[0;31m%s\x1b[0m"
        return "%s"

    def format(self, record):
        letter = record.levelname[0]
        head = self._color(record.levelno) % letter if self.colored else letter
        self._style._fmt = (head + "%(asctime)s %(process)d %(pathname)s:"
                            "%(lineno)d] %(message)s")
        return super().format(record)


def get_logger(name=None, filename=None, filemode=None, level=WARNING):
    """A configured logger (reference log.py:90): one handler per name,
    to ``filename`` (mode ``filemode``, default append) or to stderr."""
    logger = logging.getLogger(name)
    if name is not None and not getattr(logger, "_init_done", False):
        logger._init_done = True
        if filename:
            hdlr = logging.FileHandler(filename, filemode or "a")
            colored = False
        else:
            hdlr = logging.StreamHandler(sys.stderr)
            colored = getattr(sys.stderr, "isatty", lambda: False)()
        hdlr.setFormatter(_Formatter(colored=colored))
        logger.addHandler(hdlr)
        logger.setLevel(level)
    return logger


getLogger = get_logger
