"""Host utilities of the port: errors, checks, logging, timing."""

from dmlc_tpu_torch.utils.check import CacheCorruptionError, DMLCError, check, get_logger
from dmlc_tpu_torch.utils.timer import Timer, get_time

__all__ = ["CacheCorruptionError", "DMLCError", "Timer", "check", "get_logger", "get_time"]
