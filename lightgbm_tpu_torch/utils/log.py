"""Leveled logger with pluggable callback.

TPU-native analog of the reference logger (``include/LightGBM/utils/log.h:26``):
four levels (Fatal < Warning < Info < Debug), printf-style messages, and a
redirectable sink so host frameworks (tests, notebooks) can capture output the
way the reference's R/Python bindings do via ``LGBM_RegisterLogCallback``.
"""
from __future__ import annotations

import enum
import sys
from typing import Callable, Optional


class LogLevel(enum.IntEnum):
    FATAL = -1
    WARNING = 0
    INFO = 1
    DEBUG = 2


class LightGBMError(Exception):
    """Raised on fatal errors (the analog of ``Log::Fatal`` + C-API error)."""


_callback: Optional[Callable[[str], None]] = None
_level: LogLevel = LogLevel.INFO


def register_log_callback(cb: Optional[Callable[[str], None]]) -> None:
    global _callback
    _callback = cb


def reset_log_level(level: LogLevel | int) -> None:
    global _level
    _level = LogLevel(level)


def get_log_level() -> LogLevel:
    return _level


def _write(msg: str) -> None:
    if _callback is not None:
        _callback(msg + "\n")
    else:
        sys.stdout.write(msg + "\n")
        sys.stdout.flush()


class Log:
    @staticmethod
    def debug(fmt: str, *args) -> None:
        if _level >= LogLevel.DEBUG:
            _write("[LightGBM-TPU] [Debug] " + (fmt % args if args else fmt))

    @staticmethod
    def info(fmt: str, *args) -> None:
        if _level >= LogLevel.INFO:
            _write("[LightGBM-TPU] [Info] " + (fmt % args if args else fmt))

    @staticmethod
    def warning(fmt: str, *args) -> None:
        if _level >= LogLevel.WARNING:
            _write("[LightGBM-TPU] [Warning] " + (fmt % args if args else fmt))

    @staticmethod
    def fatal(fmt: str, *args) -> None:
        msg = fmt % args if args else fmt
        _write("[LightGBM-TPU] [Fatal] " + msg)
        raise LightGBMError(msg)


def check(cond: bool, msg: str = "check failed") -> None:
    """Analog of the reference's ``CHECK_*`` macros (``utils/log.h``)."""
    if not cond:
        Log.fatal(msg)
