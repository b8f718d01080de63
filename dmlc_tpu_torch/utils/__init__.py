"""Host utilities of the port: errors and checks, logging, the registry,
parameters, configuration text, timing, the serializer, blocking queues
and managed thread groups."""

from dmlc_tpu_torch.utils.check import (CacheCorruptionError, DMLCError, check, check_eq,
                                        check_ge, check_gt, check_le, check_lt, check_ne,
                                        get_logger)
from dmlc_tpu_torch.utils.concurrency import ConcurrentBlockingQueue, Spinlock
from dmlc_tpu_torch.utils.config import Config
from dmlc_tpu_torch.utils.params import Parameter, field
from dmlc_tpu_torch.utils.registry import Registry
from dmlc_tpu_torch.utils.thread_group import (ManagedThread, ShutdownToken, ThreadGroup,
                                               blocking_queue_thread, timer_thread)
from dmlc_tpu_torch.utils.timer import Timer, get_time

__all__ = ["CacheCorruptionError", "ConcurrentBlockingQueue", "Config", "DMLCError",
           "ManagedThread", "Parameter", "Registry", "ShutdownToken", "Spinlock",
           "ThreadGroup", "Timer", "blocking_queue_thread", "check", "check_eq", "check_ge",
           "check_gt", "check_le", "check_lt", "check_ne", "field", "get_logger", "get_time",
           "timer_thread"]
