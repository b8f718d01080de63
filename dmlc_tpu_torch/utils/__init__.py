"""Host utilities of the port: errors and checks, logging, parameters,
timing, the serializer."""

from dmlc_tpu_torch.utils.check import (CacheCorruptionError, DMLCError, check, check_eq,
                                        check_ge, check_gt, check_le, check_lt, check_ne,
                                        get_logger)
from dmlc_tpu_torch.utils.params import Parameter, field
from dmlc_tpu_torch.utils.timer import Timer, get_time

__all__ = ["CacheCorruptionError", "DMLCError", "Parameter", "Timer", "check", "check_eq",
           "check_ge", "check_gt", "check_le", "check_lt", "check_ne", "field", "get_logger",
           "get_time"]
