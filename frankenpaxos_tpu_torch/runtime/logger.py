"""Leveled logging with checked assertions.

Reference behavior: Logger.scala:1-118 (five levels; ``check*`` helpers;
``fatal`` raises), PrintLogger/FileLogger/FakeLogger variants.

Messages are passed lazily (callables or strings) so debug logging is
free when filtered, matching the reference's by-name parameters
(Logger.scala:26-60).
"""

from __future__ import annotations

import enum
import sys
import time
from typing import Any, Callable, Union

LazyMessage = Union[str, Callable[[], str]]


class LogLevel(enum.IntEnum):
    DEBUG = 0
    INFO = 1
    WARN = 2
    ERROR = 3
    FATAL = 4


def _force(message: LazyMessage) -> str:
    return message() if callable(message) else message


class FatalError(RuntimeError):
    """Raised by Logger.fatal (the analog of fatal returning Nothing)."""


class Logger:
    def __init__(self, log_level: LogLevel = LogLevel.DEBUG):
        self.log_level = log_level

    # --- backend hook -----------------------------------------------------
    def emit(self, level: LogLevel, message: str) -> None:
        raise NotImplementedError

    # --- leveled logging --------------------------------------------------
    def _log(self, level: LogLevel, message: LazyMessage) -> None:
        if level >= self.log_level:
            self.emit(level, _force(message))

    def debug(self, message: LazyMessage) -> None:
        self._log(LogLevel.DEBUG, message)

    def info(self, message: LazyMessage) -> None:
        self._log(LogLevel.INFO, message)

    def warn(self, message: LazyMessage) -> None:
        self._log(LogLevel.WARN, message)

    def error(self, message: LazyMessage) -> None:
        self._log(LogLevel.ERROR, message)

    def fatal(self, message: LazyMessage) -> "NoReturn":  # type: ignore[name-defined]  # noqa: F821
        text = _force(message)
        self.emit(LogLevel.FATAL, text)
        raise FatalError(text)

    # --- checked assertions (Logger.scala:62-117) -------------------------
    def check(self, condition: bool, message: LazyMessage = "check failed"):
        if not condition:
            self.fatal(message)

    def check_eq(self, lhs: Any, rhs: Any) -> None:
        if lhs != rhs:
            self.fatal(f"check_eq failed: {lhs!r} != {rhs!r}")

    def check_ne(self, lhs: Any, rhs: Any) -> None:
        if lhs == rhs:
            self.fatal(f"check_ne failed: {lhs!r} == {rhs!r}")

    def check_lt(self, lhs: Any, rhs: Any) -> None:
        if not lhs < rhs:
            self.fatal(f"check_lt failed: {lhs!r} >= {rhs!r}")

    def check_le(self, lhs: Any, rhs: Any) -> None:
        if not lhs <= rhs:
            self.fatal(f"check_le failed: {lhs!r} > {rhs!r}")

    def check_gt(self, lhs: Any, rhs: Any) -> None:
        if not lhs > rhs:
            self.fatal(f"check_gt failed: {lhs!r} <= {rhs!r}")

    def check_ge(self, lhs: Any, rhs: Any) -> None:
        if not lhs >= rhs:
            self.fatal(f"check_ge failed: {lhs!r} < {rhs!r}")


class PrintLogger(Logger):
    def emit(self, level: LogLevel, message: str) -> None:
        stream = sys.stderr if level >= LogLevel.WARN else sys.stdout
        print(f"[{level.name:5s}] {time.strftime('%H:%M:%S')} {message}",
              file=stream, flush=True)


class FileLogger(Logger):
    def __init__(self, path: str, log_level: LogLevel = LogLevel.DEBUG,
                 flush: bool = True):
        super().__init__(log_level)
        self._file = open(path, "a")
        self._flush = flush

    def emit(self, level: LogLevel, message: str) -> None:
        self._file.write(
            f"[{level.name:5s}] {time.strftime('%H:%M:%S')} {message}\n")
        if self._flush:
            self._file.flush()


class FakeLogger(Logger):
    """Captures log records for tests (FakeLogger.scala)."""

    def __init__(self, log_level: LogLevel = LogLevel.DEBUG):
        super().__init__(log_level)
        self.records: list[tuple[LogLevel, str]] = []

    def emit(self, level: LogLevel, message: str) -> None:
        self.records.append((level, message))
