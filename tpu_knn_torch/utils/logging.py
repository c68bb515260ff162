"""Logging + CHECK macros (reference: include/logging.h:31-148).

Pluggable sinks: none / stderr / file / custom callable, matching the
reference's LIB_LOGNONE / LIB_LOGSTDERR / LIB_LOGFILE / LIB_LOGCUSTOM.
"""

from __future__ import annotations

import sys
import time
from typing import Callable, TextIO

from ..core.errors import RuntimeNmsError

LEVELS = ("DEBUG", "INFO", "WARNING", "ERROR", "FATAL")


class Logger:
    def __init__(self):
        self._sink: TextIO | None = sys.stderr
        self._custom: Callable[[str, str], None] | None = None
        self.level = "INFO"

    def set_none(self):
        self._sink, self._custom = None, None

    def set_stderr(self):
        self._sink, self._custom = sys.stderr, None

    def set_file(self, path: str):
        self._sink, self._custom = open(path, "a"), None

    def set_custom(self, fn: Callable[[str, str], None]):
        self._sink, self._custom = None, fn

    def log(self, level: str, msg: str):
        if LEVELS.index(level) < LEVELS.index(self.level):
            return
        if self._custom is not None:
            self._custom(level, msg)
        elif self._sink is not None:
            ts = time.strftime("%H:%M:%S")
            print(f"[{ts} {level}] {msg}", file=self._sink, flush=True)


LOGGER = Logger()


def log(level: str, msg: str) -> None:
    LOGGER.log(level, msg)


def check(cond: bool, msg: str = "check failed") -> None:
    """Reference CHECK/CHECK_MSG: throws on failure (logging.h:123-133)."""
    if not cond:
        raise RuntimeNmsError(msg)
