"""Leveled logger: the KIRK::Log counterpart.

Counterpart of `ba_pathtracing_fur_tpu/utils/log.py`: LOG_DEBUG/INFO/WARN/
ERROR with the reference's printf-style `%` substitution (Log.h:103), a
coloured console sink and an optional file sink (Log.h:84), over Python's
logging.
"""

from __future__ import annotations

import logging
import sys
from typing import Optional

_COLORS = {"DEBUG": "\033[37m", "INFO": "\033[32m", "WARNING": "\033[33m",
           "ERROR": "\033[31m"}
_RESET = "\033[0m"

_logger: Optional[logging.Logger] = None


class _ColorFormatter(logging.Formatter):
    def format(self, record):
        base = super().format(record)
        if sys.stderr.isatty():
            return _COLORS.get(record.levelname, "") + base + _RESET
        return base


def get_logger() -> logging.Logger:
    """The package's logger, with its console sink made on first use."""
    global _logger
    if _logger is None:
        _logger = logging.getLogger("ba_pathtracing_fur_torch")
        _logger.setLevel(logging.INFO)
        hdl = logging.StreamHandler(sys.stderr)
        hdl.setFormatter(_ColorFormatter("[%(levelname).1s] %(message)s"))
        _logger.addHandler(hdl)
        _logger.propagate = False
    return _logger


def init_log_file(prefix: str) -> None:
    """Log::initLogFile: adds a file sink `{prefix}.log`."""
    hdl = logging.FileHandler(f"{prefix}.log")
    hdl.setFormatter(logging.Formatter("[%(levelname).1s %(asctime)s] %(message)s"))
    get_logger().addHandler(hdl)


def set_level(level: str) -> None:
    get_logger().setLevel(getattr(logging, level.upper()))


def _subst(fmt: str, *args) -> str:
    """The reference's `%` placeholder substitution: each `%` takes the
    next argument while arguments remain; later `%`s stay as they are."""
    out = []
    ai = 0
    for ch in fmt:
        if ch == "%" and ai < len(args):
            out.append(str(args[ai]))
            ai += 1
        else:
            out.append(ch)
    return "".join(out)


def log_debug(fmt: str, *args) -> None:
    get_logger().debug(_subst(fmt, *args))


def log_info(fmt: str, *args) -> None:
    get_logger().info(_subst(fmt, *args))


def log_warn(fmt: str, *args) -> None:
    get_logger().warning(_subst(fmt, *args))


def log_error(fmt: str, *args) -> None:
    get_logger().error(_subst(fmt, *args))
