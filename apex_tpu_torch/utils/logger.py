"""Logging setup of the port (counterpart of ``apex_tpu/utils/logger.py``):
bracketed timestamp, colored level and logger name, file:line on DEBUG,
the level from ``APEX_LOG``, INFO by default; on the logger
``"apex_tpu_torch"``. Records go to the ``sys.stderr`` of the moment they
are emitted, so a redirected or captured stderr receives them.
"""

from __future__ import annotations

import logging
import os
import sys

_COLORS = {
    "DEBUG": "\x1b[36m",
    "INFO": "\x1b[32m",
    "WARNING": "\x1b[33m",
    "ERROR": "\x1b[31m",
    "CRITICAL": "\x1b[41m",
}
_RESET = "\x1b[0m"


class _BracketFormatter(logging.Formatter):
    def __init__(self, color: bool):
        super().__init__()
        self.color = color

    def format(self, record):
        ts = self.formatTime(record, "%Y-%m-%d %H:%M:%S")
        level = record.levelname
        if self.color and level in _COLORS:
            level = f"{_COLORS[record.levelname]}{level}{_RESET}"
        loc = ""
        if record.levelno <= logging.DEBUG:
            loc = f" {record.filename}:{record.lineno}"
        return f"[{ts}] [{level}] [{record.name}{loc}] {record.getMessage()}"


class _StderrHandler(logging.StreamHandler):
    """A stream handler on whatever ``sys.stderr`` is at emit time."""

    @property
    def stream(self):
        return sys.stderr

    @stream.setter
    def stream(self, _):
        pass


def init_logger(level: str | None = None) -> logging.Logger:
    """Initialize the apex_tpu_torch logger. Level resolution: explicit arg
    > APEX_LOG env var > INFO."""
    level = level or os.environ.get("APEX_LOG", "INFO")
    logger = logging.getLogger("apex_tpu_torch")
    logger.setLevel(level.upper())
    if not logger.handlers:
        h = _StderrHandler()
        h.setFormatter(_BracketFormatter(color=sys.stderr.isatty()))
        logger.addHandler(h)
    logger.propagate = False
    return logger
