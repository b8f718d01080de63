"""Pipeline telemetry: pipeline scopes, span rings and a labeled metrics
registry.

Own copy of the part of the JAX package's ``utils/telemetry.py`` that the
input pipeline uses:

- **Pipeline scopes.** A thread-local label (:func:`scope`) is stamped on
  every span and registry metric recorded while it is active. The thread
  primitives (``ThreadedIter``, ``OrderedWorkerPool``) capture their
  creator's scope and install it on the threads they run, so everything a
  ``DeviceIter`` causes lands under its ``pipeline_label`` and two
  concurrent pipelines keep disjoint books.
- **Span rings.** One fixed-size ring a thread records ``(name, start,
  duration, pipeline, labels)`` spans with no lock (one writer a ring);
  old spans are overwritten and counted as dropped. The stage spans are
  recorded at the sites that feed the stage-seconds meters (read and parse
  in ``data/parsers.py``, cache_read there, cache_write in
  ``io/block_cache.py``, snapshot_write and snapshot_read in
  ``io/snapshot.py``, convert, dispatch, device_decode and transfer in
  ``data/device.py``), so a trace and ``DeviceIter.stats()`` tell one
  story. :func:`export_chrome_trace` writes them as Chrome-trace JSON
  (Perfetto, ``chrome://tracing``).
- **Trace mode** (``DMLC_TPU_TRACE``, :func:`trace_mode`): ``1`` wraps the
  convert, dispatch, transfer, cache_read and snapshot_read work in
  ``torch.profiler.record_function`` ranges (:func:`profiler_annotation`),
  ``chrome:<path>`` makes a ``DeviceIter`` export the span rings there when
  it closes. Torch's profiler records the CPU ranges of its own thread
  only: the ranges opened on the pipeline's threads (convert, cache_read,
  snapshot_read) show under ``torch.profiler.profile(...,
  experimental_config=torch._C._profiler._ExperimentalConfig(
  profile_all_threads=True))``.
- **Metrics registry** (:data:`REGISTRY`): counters, gauges, histograms and
  info blobs by ``(name, labels)``. The stage meters
  (:class:`~dmlc_tpu_torch.utils.timer.StageMeter`), the input-wait counter
  and the resilience events (:mod:`dmlc_tpu_torch.io.resilience`) are
  registry counters, so ``stats()`` reads one set of books.

Not ported yet: trace-context propagation, the decision log, the metrics
history, the Prometheus text form, the pod snapshot and its table, and the
registry's retirement of old pipeline scopes.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import torch

# the span and export schema, as the JAX package's
SCHEMA_VERSION = 2

# the canonical pipeline stages
STAGES = ("read", "cache_read", "parse", "convert", "dispatch", "transfer")

# registry metric names, the JAX package's
STAGE_BUSY_METRIC = "stage_busy_seconds"
STAGE_WALL_METRIC = "stage_wall_seconds"
RESILIENCE_METRIC = "resilience_events"
STALL_METRIC = "pipeline_stall"
# every second the consumer waited for input: the wait for a batch plus
# the sampled transfer landings
INPUT_WAIT_METRIC = "input_wait_seconds"


# ---------------- pipeline scopes ----------------

_tls = threading.local()
_scope_seq = itertools.count(1)


def new_pipeline_label(prefix: str = "pipeline") -> str:
    """A process-unique label (``pipeline-1``, ``pipeline-2``, ...)."""
    return f"{prefix}-{next(_scope_seq)}"


def current_scope() -> Optional[str]:
    """The pipeline label active on this thread, or None."""
    return getattr(_tls, "scope", None)


def set_scope(label: Optional[str]) -> None:
    """Install ``label`` as this thread's pipeline scope."""
    _tls.scope = label


@contextmanager
def scope(label: Optional[str]):
    """Run a block under a pipeline scope; the previous one comes back."""
    prev = current_scope()
    set_scope(label)
    try:
        yield label
    finally:
        set_scope(prev)


def scoped_target(fn: Callable[..., Any], label: Optional[str] = None) -> Callable[..., Any]:
    """Wrap a thread target so that it runs under ``label`` (default: the
    scope active where this is called, the creator's)."""
    if label is None:
        label = current_scope()

    def run(*args, **kwargs):
        set_scope(label)
        return fn(*args, **kwargs)

    return run


# ---------------- span rings ----------------

def _ring_capacity() -> int:
    try:
        return max(64, int(os.environ.get("DMLC_TPU_TRACE_RING_SPANS", "8192") or 8192))
    except ValueError:
        return 8192


def _max_rings() -> int:
    try:
        return max(8, int(os.environ.get("DMLC_TPU_TRACE_MAX_RINGS", "512") or 512))
    except ValueError:
        return 512


class _SpanRing:
    """One thread's spans. Its thread is the only writer, so recording
    takes no lock; a reader sees whole entries (a list slot store is
    atomic under the interpreter lock)."""

    __slots__ = ("tid", "thread_name", "thread", "capacity", "entries", "idx", "total",
                 "counts")

    def __init__(self, tid: int, thread_name: str, capacity: int,
                 thread: Optional[threading.Thread] = None):
        self.tid = tid
        self.thread_name = thread_name
        self.thread = thread
        self.capacity = capacity
        self.entries: List[Optional[tuple]] = [None] * capacity
        self.idx = 0
        self.total = 0
        self.counts: Dict[str, int] = {}

    def record(self, name: str, start_ns: int, dur_ns: int, pipeline: Optional[str],
               labels: Optional[dict]) -> None:
        self.entries[self.idx] = (name, start_ns, dur_ns, pipeline, labels)
        self.idx = (self.idx + 1) % self.capacity
        self.total += 1
        self.counts[name] = self.counts.get(name, 0) + 1

    def snapshot(self) -> List[tuple]:
        """The retained entries, oldest first."""
        if self.total < self.capacity:
            ent = self.entries[: self.idx]
        else:
            ent = self.entries[self.idx:] + self.entries[: self.idx]
        return [e for e in ent if e is not None]

    def clear(self) -> None:
        self.entries = [None] * self.capacity
        self.idx = 0
        self.total = 0
        self.counts = {}


_rings_lock = threading.Lock()
_rings: List[_SpanRing] = []
# a retired ring's totals, so that span_counts and spans_dropped never fall
_retired_counts: Dict[str, int] = {}
_retired_dropped = 0


def _retire_dead_ring_locked() -> None:
    """Past ``DMLC_TPU_TRACE_MAX_RINGS`` rings, drop the oldest ring whose
    thread has exited; its spans count as dropped, its totals stay."""
    global _retired_dropped
    if len(_rings) < _max_rings():
        return
    for i, ring in enumerate(_rings):
        if ring.thread is not None and not ring.thread.is_alive():
            dead = _rings.pop(i)
            for name, n in dead.counts.items():
                _retired_counts[name] = _retired_counts.get(name, 0) + n
            _retired_dropped += dead.total
            return


def _my_ring() -> _SpanRing:
    ring = getattr(_tls, "ring", None)
    if ring is None:
        t = threading.current_thread()
        ring = _SpanRing(t.ident or 0, t.name, _ring_capacity(), thread=t)
        with _rings_lock:
            _retire_dead_ring_locked()
            _rings.append(ring)
        _tls.ring = ring
    return ring


def record_span(name: str, start_s: float, dur_s: float, **labels) -> None:
    """Record one stage span: ``start_s`` a ``get_time()`` stamp and
    ``dur_s`` its duration, the values the caller adds to its stage meter.
    The active pipeline scope rides along."""
    _my_ring().record(name, int(start_s * 1e9), int(dur_s * 1e9), current_scope(),
                      labels or None)


@contextmanager
def span(name: str, **labels):
    """Time a block as one span."""
    t0 = time.monotonic()
    try:
        yield
    finally:
        record_span(name, t0, time.monotonic() - t0, **labels)


def spans_snapshot(pipeline: Optional[str] = None) -> List[dict]:
    """The retained spans of every thread as dicts, by start time;
    ``pipeline`` keeps one label's."""
    with _rings_lock:
        rings = list(_rings)
    out = []
    for ring in rings:
        for name, start_ns, dur_ns, pipe, labels in ring.snapshot():
            if pipeline is not None and pipe != pipeline:
                continue
            out.append({"name": name, "tid": ring.tid, "thread": ring.thread_name,
                        "start_ns": start_ns, "dur_ns": dur_ns, "pipeline": pipe,
                        "labels": labels or {}})
    out.sort(key=lambda s: s["start_ns"])
    return out


def span_counts() -> Dict[str, int]:
    """Spans recorded by name since the process started (overwritten and
    retired ones included)."""
    with _rings_lock:
        rings = list(_rings)
        out = dict(_retired_counts)
    for ring in rings:
        for name, n in list(ring.counts.items()):
            out[name] = out.get(name, 0) + n
    return out


def spans_dropped() -> int:
    """Spans recorded but no longer exportable."""
    with _rings_lock:
        return _retired_dropped + sum(max(0, r.total - r.capacity) for r in _rings)


def reset_spans() -> None:
    """Empty every ring (tests)."""
    global _retired_dropped
    with _rings_lock:
        for ring in _rings:
            ring.clear()
        _retired_counts.clear()
        _retired_dropped = 0


def export_chrome_trace(path: str, pipeline: Optional[str] = None) -> int:
    """Write the retained spans as Chrome-trace JSON (``{"traceEvents":
    [...]}``, complete events ``ph: "X"``, microseconds), through
    ``<path>.tmp`` and an atomic rename. Returns the spans written."""
    pid = os.getpid()
    events: List[dict] = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                           "args": {"name": "dmlc_tpu_torch"}}]
    with _rings_lock:
        rings = list(_rings)
    for ring in rings:
        events.append({"name": "thread_name", "ph": "M", "pid": pid, "tid": ring.tid,
                       "args": {"name": ring.thread_name}})
    rows = spans_snapshot(pipeline)
    for s in rows:
        args = dict(s["labels"])
        if s["pipeline"]:
            args["pipeline"] = s["pipeline"]
        events.append({"name": s["name"], "cat": "dmlc_tpu", "ph": "X", "pid": pid,
                       "tid": s["tid"], "ts": s["start_ns"] / 1e3, "dur": s["dur_ns"] / 1e3,
                       "args": args})
    doc = {"traceEvents": events, "displayTimeUnit": "ms",
           "otherData": {"telemetry_schema_version": SCHEMA_VERSION,
                         "spans_dropped": spans_dropped()}}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)
    return len(rows)


# ---------------- trace mode ----------------

def trace_mode() -> Tuple[str, Optional[str]]:
    """``DMLC_TPU_TRACE``, as the JAX package reads it: ``1`` is
    ``("annotate", None)``, ``chrome:<path>`` is ``("chrome", path)``,
    anything else (unset and ``0`` included) ``("off", None)``."""
    value = os.environ.get("DMLC_TPU_TRACE", "").strip()
    if value == "1":
        return "annotate", None
    if value.startswith("chrome:"):
        return "chrome", value[len("chrome:"):]
    return "off", None


def profiler_annotation(name: str, enabled: bool = True):
    """A ``torch.profiler.record_function`` range named ``name`` when
    enabled, else a no-op. Callers read :func:`trace_mode` once, never a
    batch."""
    if not enabled:
        return contextlib.nullcontext()
    return torch.profiler.record_function(name)


# ---------------- metrics registry ----------------

class _Metric:
    __slots__ = ("lock", "labels")

    def __init__(self, labels: Dict[str, str]):
        self.lock = threading.Lock()
        self.labels = labels


class Counter(_Metric):
    """A monotonic float counter."""

    __slots__ = ("_value",)
    kind = "counter"

    def __init__(self, labels):
        super().__init__(labels)
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        with self.lock:
            self._value += n

    @property
    def value(self) -> float:
        with self.lock:
            return self._value


class Gauge(_Metric):
    """A value that is set."""

    __slots__ = ("_value",)
    kind = "gauge"

    def __init__(self, labels):
        super().__init__(labels)
        self._value = 0.0

    def set(self, v: float) -> None:
        with self.lock:
            self._value = float(v)

    @property
    def value(self) -> float:
        with self.lock:
            return self._value


class Histogram(_Metric):
    """count / sum / min / max of the observed values."""

    __slots__ = ("_count", "_sum", "_min", "_max")
    kind = "histogram"

    def __init__(self, labels):
        super().__init__(labels)
        self._count = 0
        self._sum = 0.0
        self._min = None
        self._max = None

    def observe(self, v: float) -> None:
        v = float(v)
        with self.lock:
            self._count += 1
            self._sum += v
            self._min = v if self._min is None else min(self._min, v)
            self._max = v if self._max is None else max(self._max, v)

    @property
    def value(self) -> dict:
        with self.lock:
            return {"count": self._count, "sum": self._sum, "min": self._min,
                    "max": self._max}


class Info(_Metric):
    """A JSON-able dict; the last write wins."""

    __slots__ = ("_value",)
    kind = "info"

    def __init__(self, labels):
        super().__init__(labels)
        self._value: Optional[dict] = None

    def set(self, value: dict) -> None:
        with self.lock:
            self._value = dict(value)

    @property
    def value(self) -> Optional[dict]:
        with self.lock:
            return dict(self._value) if self._value is not None else None


class MetricsRegistry:
    """Metrics by name and labels. ``counter`` / ``gauge`` / ``histogram``
    / ``info`` get or create the handle of one ``(name, labels)``; a
    caller keeps its handles, so the hot path takes only the metric's own
    lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[tuple, _Metric] = {}

    def _get(self, cls, name: str, labels: Dict[str, str]) -> _Metric:
        key = (cls.kind, name, tuple(sorted(labels.items())))
        m = self._metrics.get(key)
        if m is None:
            with self._lock:
                m = self._metrics.get(key)
                if m is None:
                    m = cls(dict(labels))
                    self._metrics[key] = m
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(Histogram, name, labels)

    def info(self, name: str, **labels) -> Info:
        return self._get(Info, name, labels)

    def _rows(self, name: Optional[str], kind: Optional[str],
              label_filter: Dict[str, str]) -> Iterable[Tuple[tuple, _Metric]]:
        with self._lock:
            items = list(self._metrics.items())
        for key, m in items:
            if name is not None and key[1] != name:
                continue
            if kind is not None and key[0] != kind:
                continue
            if any(m.labels.get(fk) != fv for fk, fv in label_filter.items()):
                continue
            yield key, m

    def snapshot(self, name: Optional[str] = None, kind: Optional[str] = None,
                 **label_filter) -> List[dict]:
        """The matching metrics as ``{"kind", "name", "labels", "value"}``."""
        return [{"kind": key[0], "name": key[1], "labels": dict(m.labels), "value": m.value}
                for key, m in self._rows(name, kind, label_filter)]

    def sum(self, name: str, **label_filter) -> float:
        """The total over the matching counters and gauges."""
        return sum(m.value for _, m in self._rows(name, None, label_filter)
                   if isinstance(m, (Counter, Gauge)))

    def sum_by(self, name: str, by: str, **label_filter) -> Dict[str, float]:
        """Totals of the matching counters and gauges by the label ``by``."""
        out: Dict[str, float] = {}
        for _, m in self._rows(name, None, label_filter):
            if isinstance(m, (Counter, Gauge)):
                k = m.labels.get(by, "")
                out[k] = out.get(k, 0.0) + m.value
        return out

    def clear(self, name: Optional[str] = None) -> None:
        """Drop the metrics named ``name``, or every metric."""
        with self._lock:
            if name is None:
                self._metrics.clear()
            else:
                self._metrics = {k: v for k, v in self._metrics.items() if k[1] != name}


REGISTRY = MetricsRegistry()
