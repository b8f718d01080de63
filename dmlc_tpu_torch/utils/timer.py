"""Wall-clock timing, stage meters and throughput counters — analog of
dmlc::GetTime (timer.h:27).

Own copy of the JAX package's ``utils/timer.py``: :func:`get_time`,
:class:`StageMeter` (named stage seconds as registry counters),
:func:`format_stage_table`, :class:`Timer` and :class:`ThroughputMeter`.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Iterable, Optional

from dmlc_tpu_torch.utils import telemetry as _telemetry
from dmlc_tpu_torch.utils.check import get_logger


def get_time() -> float:
    """Seconds, monotonic."""
    return time.monotonic()


class StageMeter:
    """Thread-safe seconds by named stage, each stage a registry counter
    (``metric``, labels ``stage`` and ``pipeline=scope``), so
    ``DeviceIter.stats()`` and anything else reading the registry read the
    same books. Stages named up front are reported at 0 before they run;
    ``scope`` defaults to a fresh label, so two meters never share a
    counter by accident."""

    def __init__(self, *stages: str, metric: str = _telemetry.STAGE_BUSY_METRIC,
                 scope: Optional[str] = None):
        self._metric = metric
        self.scope = scope if scope is not None else _telemetry.new_pipeline_label("meter")
        self._lock = threading.Lock()  # guards the growth of the handle map
        self._handles: Dict[str, _telemetry.Counter] = {
            s: _telemetry.REGISTRY.counter(metric, stage=s, pipeline=self.scope)
            for s in stages}

    def _handle(self, stage: str) -> _telemetry.Counter:
        h = self._handles.get(stage)
        if h is None:
            with self._lock:
                h = self._handles.get(stage)
                if h is None:
                    h = _telemetry.REGISTRY.counter(self._metric, stage=stage,
                                                    pipeline=self.scope)
                    self._handles[stage] = h
        return h

    def add(self, stage: str, seconds: float) -> None:
        self._handle(stage).inc(seconds)

    def seconds(self) -> Dict[str, float]:
        """The cumulative seconds by stage."""
        with self._lock:
            handles = dict(self._handles)
        return {s: h.value for s, h in handles.items()}

    def total(self) -> float:
        return sum(self.seconds().values())


def format_stage_table(stages: Dict[str, float], wall: float,
                       order: Optional[Iterable[str]] = None) -> str:
    """A stage table: seconds and share of ``wall`` a stage, then
    ``other`` (wall less the stages) and ``wall``."""
    keys = list(order) if order is not None else list(stages)
    rows = [(k, stages.get(k, 0.0)) for k in keys]
    covered = sum(s for _, s in rows)
    rows.append(("other", max(0.0, wall - covered)))
    width = max(len(k) for k, _ in rows)
    lines = [f"{'stage':<{width}}  seconds  % of wall"]
    for name, sec in rows:
        pct = 100.0 * sec / wall if wall > 0 else 0.0
        lines.append(f"{name:<{width}}  {sec:7.3f}  {pct:8.1f}%")
    lines.append(f"{'wall':<{width}}  {wall:7.3f}  {100.0 if wall > 0 else 0.0:8.1f}%")
    return "\n".join(lines)


class Timer:
    """Context-manager stopwatch."""

    def __init__(self):
        self.start = 0.0
        self.elapsed = 0.0

    def __enter__(self) -> "Timer":
        self.start = get_time()
        return self

    def __exit__(self, *exc) -> None:
        self.elapsed = get_time() - self.start


class ThroughputMeter:
    """Bytes in and items out, logged every ``log_every_mb`` MB as ``N MB
    read, X MB/sec`` (basic_row_iter.h:68-81), with a stall counter."""

    def __init__(self, name: str = "load", log_every_mb: float = 10.0, silent: bool = False):
        self.name = name
        self.log_every = log_every_mb * (1 << 20)
        self.silent = silent
        self.bytes = 0
        self.items = 0
        self.stall_seconds = 0.0
        self._next_log = self.log_every
        self._start: Optional[float] = None

    def start(self) -> None:
        if self._start is None:
            self._start = get_time()

    def add(self, nbytes: int, nitems: int = 0) -> None:
        self.start()
        self.bytes += nbytes
        self.items += nitems
        if not self.silent and self.bytes >= self._next_log:
            self._next_log += self.log_every
            get_logger().info("%s: %.1f MB read, %.2f MB/sec", self.name, self.mb,
                              self.mb_per_sec)

    def add_stall(self, seconds: float) -> None:
        self.stall_seconds += seconds

    @property
    def mb(self) -> float:
        return self.bytes / (1 << 20)

    @property
    def elapsed(self) -> float:
        return 0.0 if self._start is None else get_time() - self._start

    @property
    def mb_per_sec(self) -> float:
        e = self.elapsed
        return self.mb / e if e > 0 else 0.0

    def summary(self) -> dict:
        return {"name": self.name, "mb": self.mb, "items": self.items,
                "seconds": self.elapsed, "mb_per_sec": self.mb_per_sec,
                "stall_seconds": self.stall_seconds}

    def log_final(self) -> None:
        if not self.silent:
            get_logger().info("%s: finished %.1f MB in %.2f s, %.2f MB/sec (stall %.3f s)",
                              self.name, self.mb, self.elapsed, self.mb_per_sec,
                              self.stall_seconds)
