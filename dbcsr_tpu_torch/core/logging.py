"""Logger objects with an output stream and a default-logger stack.

Copy of ``dbcsr_tpu/core/logging.py`` (reference ``dbcsr_log_handling.F``):
loggers carry an output unit (here a stream) and nest via a stack so
library layers inherit the active logger. The JAX package prints only on
its designated I/O process of a multi-host run; so does the port in a
run brought up by ``init_lib(distributed=True)`` (a single process is its
own I/O process). The default prefix names the port's package.
"""
from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import List

__all__ = [
    "Logger",
    "get_logger",
    "push_logger",
    "pop_logger",
    "log",
    "LOG_ERROR",
    "LOG_WARNING",
    "LOG_NOTE",
    "LOG_DEBUG",
]

LOG_ERROR = 0
LOG_WARNING = 1
LOG_NOTE = 2
LOG_DEBUG = 3
_NAMES = {0: "ERROR", 1: "WARN", 2: "NOTE", 3: "DEBUG"}


@dataclass
class Logger:
    stream: object = None  # defaults to stdout at call time
    level: int = LOG_NOTE
    prefix: str = "dbcsr_tpu_torch"
    #: the process that prints (the reference's io-unit-per-rank): the
    #: world rank of a distributed run
    io_process: int = 0

    def _unit(self):
        return self.stream or sys.stdout

    def _is_io_process(self) -> bool:
        from ..dist import comm

        return comm.rank() == self.io_process

    def log(self, level: int, message: str) -> None:
        if level > self.level or not self._is_io_process():
            return
        print(f"[{self.prefix}:{_NAMES.get(level, level)}] {message}",
              file=self._unit())

    def error(self, message: str) -> None:
        self.log(LOG_ERROR, message)

    def warning(self, message: str) -> None:
        self.log(LOG_WARNING, message)

    def note(self, message: str) -> None:
        self.log(LOG_NOTE, message)

    def debug(self, message: str) -> None:
        self.log(LOG_DEBUG, message)


_stack: List[Logger] = [Logger()]


def get_logger() -> Logger:
    return _stack[-1]


def push_logger(logger: Logger) -> None:
    _stack.append(logger)


def pop_logger() -> Logger:
    if len(_stack) > 1:
        return _stack.pop()
    return _stack[0]


def log(level: int, message: str) -> None:
    get_logger().log(level, message)
