from .log import Log, LogLevel, LightGBMError, register_log_callback, reset_log_level, check
from .random_gen import Random
from . import common

__all__ = [
    "Log", "LogLevel", "LightGBMError", "register_log_callback",
    "reset_log_level", "check", "Random", "common",
]
