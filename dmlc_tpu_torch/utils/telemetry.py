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
- **Profiler ranges** (:func:`profiler_annotation`): the convert,
  dispatch, transfer, input_wait, cache_read and snapshot_read work, and
  the learners' step (``dmlc_tpu.step``, which ``FMLearner`` tiles with
  ``.forward``, ``.backward`` and ``.optimizer``), open
  ``torch.profiler.record_function`` ranges named ``dmlc_tpu.*`` whenever
  a torch profiler is recording, and nothing otherwise. Torch's profiler
  records the CPU ranges of its own thread only: the ranges opened on the
  pipeline's threads (convert, cache_read, snapshot_read) show under
  ``torch.profiler.profile(..., experimental_config=
  torch._C._profiler._ExperimentalConfig(profile_all_threads=True))``.
  Profiler ranges are stamped on the profiler's clock, so they lie on the
  device's timeline; the span rings are on ``time.monotonic``'s clock and
  do not.
- **Trace mode** (``DMLC_TPU_TRACE``, :func:`trace_mode`): parsed as the
  JAX package parses it; ``chrome:<path>`` makes a ``DeviceIter`` export
  the span rings there when it closes. ``1`` needs nothing of its own: the
  ranges follow the profiler.
- **Metrics registry** (:data:`REGISTRY`): counters, gauges, histograms and
  info blobs by ``(name, labels)``. The stage meters
  (:class:`~dmlc_tpu_torch.utils.timer.StageMeter`), the input-wait counter
  and the resilience events (:mod:`dmlc_tpu_torch.io.resilience`) are
  registry counters, so ``stats()`` reads one set of books. Past
  ``DMLC_TPU_METRICS_MAX_PIPELINES`` pipeline scopes the least recently
  touched one retires: its counters and histograms fold into the
  ``pipeline=""`` totals, its gauges and info blobs go.
- **Trace context** (:func:`trace`, :func:`trace_context_wire` /
  :func:`trace_context_from_wire`, :func:`set_trace_propagation`): a
  thread-local ``(trace_id, span_id)`` stamped on the spans recorded under
  it, with the JAX package's wire form.
- **Decision log** (:func:`record_decision`): one event shape for every
  controller (the autotuner's moves among them), a bounded ring and a
  ``decision_events`` counter a ``(component, action)``.
- **Metrics history** (:func:`sample_metrics_history`), **Prometheus text**
  (:func:`render_prometheus`, :func:`parse_prometheus_text`) and the **pod
  view** (:func:`pod_snapshot`, :func:`format_pod_table`,
  :func:`component_snapshot`, :func:`export_pod_trace`), the JAX
  package's, output for output; the ``store`` block reads the tiered
  artifact store's live bytes and events (:mod:`dmlc_tpu_torch.store`).
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
import torch.autograd.profiler as _profiler_mod

from dmlc_tpu_torch.utils import knobs as _knobs

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
# the port's own: the thread CPU seconds of the intervals that the convert
# stage's busy seconds count (the rest of them is off-CPU: the wait for
# the interpreter lock and preemption)
CONVERT_CPU_METRIC = "convert_cpu_seconds"
# the autotuner's mirrors: a gauge a knob and a steps counter, by pipeline
AUTOTUNE_KNOB_METRIC = "autotune_knob"
AUTOTUNE_STEP_METRIC = "autotune_steps"
# the JAX package's store and service metric names, read by the pod view
STORE_BYTES_METRIC = "store_bytes"
SERVICE_JOB_WAIT_METRIC = "service_job_input_wait_seconds"
SERVICE_JOB_PARTS_METRIC = "service_job_parts"
SERVICE_JOB_SLO_METRIC = "service_job_slo_wait_frac"
SERVICE_WIRE_RAW_METRIC = "service_wire_bytes_raw"
SERVICE_WIRE_SENT_METRIC = "service_wire_bytes_sent"
# the decision log's counter, labeled (component, action)
DECISION_METRIC = "decision_events"


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


# ---------------- distributed trace context ----------------
#
# A trace context is ``(trace_id, span_id)``: the trace a causal chain
# belongs to and the span id the next hop parents under. It crosses
# processes as an optional ``{"trace": {"tid", "sid"}}`` key, and within a
# process a thread-local copy stamps trace_id / parent_id on every span
# recorded while it is installed.

# the in-process override of the DMLC_TPU_TRACE_CONTEXT switch
_trace_propagation: Optional[bool] = None


def set_trace_propagation(enabled: Optional[bool]) -> None:
    """Force trace-context propagation on/off for this process
    (``None`` restores the ``DMLC_TPU_TRACE_CONTEXT`` env default)."""
    global _trace_propagation
    _trace_propagation = None if enabled is None else bool(enabled)


def trace_propagation_enabled() -> bool:
    """Master switch for cross-process trace context: on by default,
    ``DMLC_TPU_TRACE_CONTEXT=0`` (or :func:`set_trace_propagation`)
    turns the wire key + span stamping off."""
    if _trace_propagation is not None:
        return _trace_propagation
    return os.environ.get("DMLC_TPU_TRACE_CONTEXT", "").strip() != "0"


def new_trace_id() -> str:
    """A fresh 64-bit hex trace id (one per (job, part) causal chain)."""
    return os.urandom(8).hex()


def new_span_id() -> str:
    """A fresh 32-bit hex span id (for spans that hand a context on)."""
    return os.urandom(4).hex()


def current_trace() -> Optional[Tuple[str, str]]:
    """The ``(trace_id, parent span_id)`` context active on this thread,
    or None."""
    return getattr(_tls, "trace", None)


def set_trace(ctx: Optional[Tuple[str, str]]) -> None:
    """Install ``ctx`` as this thread's trace context."""
    _tls.trace = ctx


@contextmanager
def trace(trace_id: Optional[str], span_id: str = ""):
    """Run a block under a trace context — spans recorded inside inherit
    ``trace_id``/``parent_id`` automatically; restores the previous
    context. A falsy ``trace_id`` clears the context for the block."""
    prev = current_trace()
    set_trace((trace_id, span_id) if trace_id else None)
    try:
        yield
    finally:
        set_trace(prev)


def trace_context_wire(
        ctx: Optional[Tuple[str, str]] = None) -> Optional[dict]:
    """The compact wire form ``{"tid", "sid"}`` of ``ctx`` (default:
    this thread's context), or None when absent/disabled. Callers attach
    it under the ``"trace"`` request key only when non-None, so peers
    that predate tracing never see the key."""
    if not trace_propagation_enabled():
        return None
    if ctx is None:
        ctx = current_trace()
    if not ctx or not ctx[0]:
        return None
    return {"tid": ctx[0], "sid": ctx[1] or ""}


def trace_context_from_wire(obj: Any) -> Optional[Tuple[str, str]]:
    """Parse an incoming ``"trace"`` wire key back into a context.
    Malformed shapes yield None — observability must never fail an
    RPC."""
    if not trace_propagation_enabled() or not isinstance(obj, dict):
        return None
    tid = obj.get("tid")
    if not isinstance(tid, str) or not tid:
        return None
    sid = obj.get("sid")
    return (tid, sid if isinstance(sid, str) else "")


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
               labels: Optional[dict], trace_id: Optional[str] = None,
               parent_id: Optional[str] = None, span_id: Optional[str] = None) -> None:
        self.entries[self.idx] = (name, start_ns, dur_ns, pipeline, labels, trace_id,
                                  parent_id, span_id)
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


def record_span(name: str, start_s: float, dur_s: float, trace_id: Optional[str] = None,
                parent_id: Optional[str] = None, span_id: Optional[str] = None,
                **labels) -> None:
    """Record one stage span: ``start_s`` a ``get_time()`` stamp and
    ``dur_s`` its duration, the values the caller adds to its stage meter.
    The active pipeline scope rides along, and so does the active trace
    context unless ``trace_id`` / ``parent_id`` are given; ``span_id``
    names this span for a next hop to parent under."""
    if trace_id is None:
        ctx = current_trace()
        if ctx is not None:
            trace_id = ctx[0]
            if parent_id is None:
                parent_id = ctx[1] or None
    _my_ring().record(name, int(start_s * 1e9), int(dur_s * 1e9), current_scope(),
                      labels or None, trace_id, parent_id, span_id)


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
        for (name, start_ns, dur_ns, pipe, labels, trace_id, parent_id,
             span_id) in ring.snapshot():
            if pipeline is not None and pipe != pipeline:
                continue
            row = {"name": name, "tid": ring.tid, "thread": ring.thread_name,
                   "start_ns": start_ns, "dur_ns": dur_ns, "pipeline": pipe,
                   "labels": labels or {}}
            # the trace fields only on the spans of a trace
            if trace_id:
                row["trace_id"] = trace_id
            if parent_id:
                row["parent_id"] = parent_id
            if span_id:
                row["span_id"] = span_id
            out.append(row)
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
        for k in ("trace_id", "parent_id", "span_id"):
            if s.get(k):
                args[k] = s[k]
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


# ---------------- trace mode and profiler ranges ----------------

_NO_RANGE = contextlib.nullcontext()


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
    """A ``torch.profiler.record_function`` range named ``name`` while a
    torch profiler is recording (the check is one module attribute read:
    torch's own process-wide flag, set by every profiler session, those
    that record all threads included), else a shared no-op. ``enabled`` is
    the JAX package's switch: False opens nothing; the port's own callers
    leave it, so their ranges follow the profiler alone."""
    if enabled and _profiler_mod._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_RANGE


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


def _metrics_max_pipelines() -> int:
    """``DMLC_TPU_METRICS_MAX_PIPELINES``: the pipeline scopes the registry
    keeps before it retires the least recently touched one."""
    return _knobs.resolve("metrics_max_pipelines")


class MetricsRegistry:
    """Metrics by name and labels. ``counter`` / ``gauge`` / ``histogram``
    / ``info`` get or create the handle of one ``(name, labels)``; a
    caller keeps its handles, so the hot path takes only the metric's own
    lock.

    Past ``DMLC_TPU_METRICS_MAX_PIPELINES`` distinct ``pipeline`` labels
    (a metric's creation touches its label), the least recently touched
    one retires: its counters and histograms fold into the same metric
    with ``pipeline=""`` (so totals over the other labels stay), its
    gauges and info blobs are dropped (:meth:`retired_pipelines` counts
    the retirements)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[tuple, _Metric] = {}
        # pipeline label -> its last touch; the retirement tally
        self._pipeline_touch: Dict[str, int] = {}
        self._touch_seq = itertools.count(1)
        self._retired_pipelines = 0

    def _retire_pipeline_locked(self, pipeline: str) -> None:
        self._pipeline_touch.pop(pipeline, None)
        self._retired_pipelines += 1
        tag = ("pipeline", pipeline)
        for key in [k for k in self._metrics if tag in k[2]]:
            old = self._metrics.pop(key)
            if not isinstance(old, (Counter, Histogram)):
                continue  # gauges and info blobs are one instance's state
            kind, name, label_items = key
            folded = tuple(sorted((lk, "" if lk == "pipeline" else lv)
                                  for lk, lv in label_items))
            tgt = self._metrics.get((kind, name, folded))
            if tgt is None:
                tgt = self._metrics[(kind, name, folded)] = type(old)(dict(folded))
            if isinstance(old, Counter):
                tgt.inc(old.value)
                continue
            v = old.value
            with tgt.lock:
                tgt._count += v["count"]
                tgt._sum += v["sum"]
                if v["min"] is not None:
                    tgt._min = v["min"] if tgt._min is None else min(tgt._min, v["min"])
                if v["max"] is not None:
                    tgt._max = v["max"] if tgt._max is None else max(tgt._max, v["max"])

    def _touch_pipeline_locked(self, pipeline: str) -> None:
        self._pipeline_touch[pipeline] = next(self._touch_seq)
        if len(self._pipeline_touch) <= _metrics_max_pipelines():
            return
        oldest = min(self._pipeline_touch, key=self._pipeline_touch.get)
        if oldest != pipeline:
            self._retire_pipeline_locked(oldest)

    def retired_pipelines(self) -> int:
        """The pipeline scopes retired so far."""
        with self._lock:
            return self._retired_pipelines

    def _get(self, cls, name: str, labels: Dict[str, str]) -> _Metric:
        key = (cls.kind, name, tuple(sorted(labels.items())))
        m = self._metrics.get(key)
        if m is None:
            with self._lock:
                m = self._metrics.get(key)
                if m is None:
                    m = cls(dict(labels))
                    self._metrics[key] = m
                    if labels.get("pipeline"):
                        self._touch_pipeline_locked(labels["pipeline"])
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
                self._pipeline_touch.clear()
                self._retired_pipelines = 0
            else:
                self._metrics = {k: v for k, v in self._metrics.items() if k[1] != name}


REGISTRY = MetricsRegistry()


# ---------------- control-decision audit ledger ----------------

# retained decision events per process: the ledger is a bounded ring
# (old events drop, the DECISION_METRIC counters stay monotonic), sized
# for "why did the fleet do that" forensics, not for history
DECISION_HISTORY_LIMIT = 256

_decisions_lock = threading.Lock()
_decisions: List[dict] = []
_decisions_total = 0


def record_decision(component: str, action: str,
                    trigger: Optional[dict] = None,
                    outcome: Optional[Any] = None, **extra) -> dict:
    """Append one structured control-decision event to the audit ledger
    (docs/observability.md Decision ledger). One shape for every
    controller: ``component`` (autotune / autoscaler / dispatcher /
    store / worker), ``action`` (grow, drain, evict, hedge, throttle,
    ...), ``trigger`` (the metric deltas that fired it), ``outcome``
    (what changed). The event also bumps the ``decision_events``
    registry counter and inherits the active trace context so a
    decision shows up inside the trace it affected. Returns the event
    dict — fleet components journal exactly this via the dispatcher
    append-journal."""
    global _decisions_total
    event: Dict[str, Any] = {
        "ts": round(time.monotonic(), 6),
        "component": str(component),
        "action": str(action),
    }
    if trigger:
        event["trigger"] = dict(trigger)
    if outcome is not None:
        event["outcome"] = outcome
    ctx = current_trace()
    if ctx and ctx[0]:
        event["trace_id"] = ctx[0]
    for k, v in extra.items():
        if v is not None:
            event[k] = v
    with _decisions_lock:
        _decisions.append(event)
        _decisions_total += 1
        if len(_decisions) > DECISION_HISTORY_LIMIT:
            del _decisions[: len(_decisions) - DECISION_HISTORY_LIMIT]
    REGISTRY.counter(DECISION_METRIC, component=str(component),
                     action=str(action)).inc()
    return event


def decisions_snapshot(component: Optional[str] = None) -> List[dict]:
    """Retained decision events, oldest-first, optionally filtered to
    one component. Dicts are copies — callers may annotate freely."""
    with _decisions_lock:
        events = list(_decisions)
    return [dict(e) for e in events
            if component is None or e.get("component") == component]


def decisions_total() -> int:
    """Decisions RECORDED since process start (ring drops don't lower
    this)."""
    with _decisions_lock:
        return _decisions_total


def decision_counts() -> Dict[str, int]:
    """``component.action`` -> count since process start, from the
    registry shadow counter (monotonic across ring drops) — what
    ``pod_snapshot()['decisions']`` ships to the tracker."""
    out: Dict[str, int] = {}
    for row in REGISTRY.snapshot(DECISION_METRIC, "counter"):
        labels = row["labels"]
        key = f"{labels.get('component', '?')}.{labels.get('action', '?')}"
        out[key] = out.get(key, 0) + int(round(row["value"]))
    return out


def reset_decisions() -> None:
    """Clear the ledger (tests; production rings just wrap)."""
    global _decisions_total
    with _decisions_lock:
        _decisions.clear()
        _decisions_total = 0
    REGISTRY.clear(DECISION_METRIC)


# ---------------- bounded metrics time-series ring ----------------

def _metrics_history_limit() -> int:
    """``DMLC_TPU_METRICS_HISTORY``: the samples the history ring keeps."""
    return _knobs.resolve("metrics_history")


_history_lock = threading.Lock()
_history: List[dict] = []


def sample_metrics_history(now: Optional[float] = None) -> dict:
    """Capture one bounded time-series sample of the hot fleet gauges —
    per-job input wait, wire bytes, store bytes, decision count — so
    post-hoc questions like "what did input_wait look like when the
    autoscaler grew" are answerable from the ring alone. The fleet
    autoscaler samples once per control tick; anything else may call it
    too (the ring just wraps)."""
    sample = {
        "ts": round(time.monotonic() if now is None else now, 6),
        "input_wait_seconds": round(REGISTRY.sum(INPUT_WAIT_METRIC), 4),
        "job_wait_seconds": {
            j: round(v, 4) for j, v in
            REGISTRY.sum_by(SERVICE_JOB_WAIT_METRIC, "job").items() if j},
        "wire_bytes_raw": int(REGISTRY.sum(SERVICE_WIRE_RAW_METRIC)),
        "wire_bytes_sent": int(REGISTRY.sum(SERVICE_WIRE_SENT_METRIC)),
        "store_bytes": int(REGISTRY.sum(STORE_BYTES_METRIC)),
        "decisions": decisions_total(),
    }
    limit = _metrics_history_limit()
    with _history_lock:
        _history.append(sample)
        if len(_history) > limit:
            del _history[: len(_history) - limit]
    return dict(sample)


def metrics_history() -> List[dict]:
    """The retained time-series samples, oldest-first (copies)."""
    with _history_lock:
        return [dict(s) for s in _history]


def reset_metrics_history() -> None:
    """Clear the ring (tests)."""
    with _history_lock:
        _history.clear()


# ---------------- Prometheus text-format exposition ----------------

_PROM_PREFIX = "dmlc_tpu_"


def _prom_name(name: str) -> str:
    out = []
    for ch in name:
        out.append(ch if (ch.isalnum() and ch.isascii()) or ch in "_:"
                   else "_")
    base = "".join(out)
    if base and base[0].isdigit():
        base = "_" + base
    return _PROM_PREFIX + base


def _prom_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    parts = []
    for k in sorted(labels):
        v = str(labels[k]).replace("\\", "\\\\").replace("\n", "\\n") \
            .replace('"', '\\"')
        parts.append(f'{k}="{v}"')
    return "{" + ",".join(parts) + "}"


def render_prometheus(rows: Optional[List[dict]] = None) -> str:
    """Render registry snapshot rows as Prometheus text exposition
    format (docs/observability.md Prometheus exposition). Stable naming
    contract: every metric is prefixed ``dmlc_tpu_``, counters gain the
    conventional ``_total`` suffix, histograms expose their
    count/sum/min/max summary as ``_count``/``_sum``/``_min``/``_max``
    samples, info blobs (structured JSON, not numeric) are skipped.
    Output is deterministically sorted; the ``metrics_text`` RPC on
    dispatcher and workers serves exactly this."""
    if rows is None:
        rows = REGISTRY.snapshot()
    typed: Dict[str, str] = {}
    samples: List[Tuple[str, str, float]] = []
    for row in rows:
        kind = row["kind"]
        if kind == "info":
            continue
        name = _prom_name(row["name"])
        labels = {k: v for k, v in (row["labels"] or {}).items()
                  if v not in (None, "")}
        if kind == "counter":
            typed.setdefault(name + "_total", "counter")
            samples.append((name + "_total", _prom_labels(labels),
                            float(row["value"])))
        elif kind == "gauge":
            typed.setdefault(name, "gauge")
            samples.append((name, _prom_labels(labels),
                            float(row["value"])))
        elif kind == "histogram":
            v = row["value"] or {}
            for part in ("count", "sum", "min", "max"):
                pv = v.get(part)
                if pv is None:
                    continue
                typed.setdefault(f"{name}_{part}", "gauge")
                samples.append((f"{name}_{part}", _prom_labels(labels),
                                float(pv)))
    lines: List[str] = []
    last_name = None
    for name, label_str, value in sorted(samples):
        if name != last_name:
            lines.append(f"# TYPE {name} {typed[name]}")
            last_name = name
        try:
            text = str(int(value)) if value == int(value) else repr(value)
        except (OverflowError, ValueError):  # inf / nan
            text = repr(value)
        lines.append(f"{name}{label_str} {text}")
    return "\n".join(lines) + ("\n" if lines else "")


def parse_prometheus_text(text: str) -> List[Tuple[str, Dict[str, str],
                                                   float]]:
    """Minimal Prometheus text-format parser — the round-trip check
    behind the exposition tests. Returns
    ``(name, labels, value)`` samples; raises ValueError on any
    malformed sample line."""
    import re

    sample_re = re.compile(
        r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{(.*)\})?\s+(\S+)$')
    label_re = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
    out: List[Tuple[str, Dict[str, str], float]] = []
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        m = sample_re.match(line)
        if m is None:
            raise ValueError(f"malformed exposition line: {raw!r}")
        name, _, label_blob, value_text = m.groups()
        labels: Dict[str, str] = {}
        if label_blob:
            pos = 0
            while pos < len(label_blob):
                lm = label_re.match(label_blob, pos)
                if lm is None:
                    raise ValueError(f"malformed labels: {raw!r}")
                labels[lm.group(1)] = (lm.group(2)
                                       .replace('\\"', '"')
                                       .replace("\\n", "\n")
                                       .replace("\\\\", "\\"))
                pos = lm.end()
                if pos < len(label_blob):
                    if label_blob[pos] != ",":
                        raise ValueError(f"malformed labels: {raw!r}")
                    pos += 1
        try:
            value = float(value_text)
        except ValueError:
            raise ValueError(f"malformed sample value: {raw!r}") from None
        out.append((name, labels, value))
    return out


# ---------------- pod-scale aggregation ----------------

def pod_snapshot() -> dict:
    """This process's registry as a compact JSON-able snapshot — what a
    worker ships to the tracker over the heartbeat path. Stage seconds and
    resilience events are summed ACROSS pipeline labels (the tracker's
    unit of balance is the host, not the pipeline instance)."""
    stages = REGISTRY.sum_by(STAGE_BUSY_METRIC, "stage")
    # 'transfer' lives on the wall meter only (it is a sampled consumer-
    # side probe, not a pipeline-thread busy counter) — merge it in so a
    # transfer-bound rank is visible in the pod table
    transfer = REGISTRY.sum_by(STAGE_WALL_METRIC, "stage").get("transfer")
    if transfer:
        stages["transfer"] = stages.get("transfer", 0.0) + transfer
    events = REGISTRY.sum_by(RESILIENCE_METRIC, "event")
    # per-job data-service breakdown (docs/service.md multi-tenant
    # service): client-side input wait + worker-side parts served,
    # keyed by job — the autoscaler's fleet-wide signal is the sum of
    # these across ranks (additive key; schema stays v1 because old
    # readers ignore it and every v1 field is unchanged)
    job_waits = REGISTRY.sum_by(SERVICE_JOB_WAIT_METRIC, "job")
    job_parts = REGISTRY.sum_by(SERVICE_JOB_PARTS_METRIC, "job")
    jobs = {j: {"input_wait_seconds": round(job_waits.get(j, 0.0), 4),
                "parts": int(round(job_parts.get(j, 0)))}
            for j in sorted(set(job_waits) | set(job_parts)) if j}
    # SLO targets ride beside the wait they bound (docs/service.md
    # Production QoS) — a gauge, identical across a job's ranks, so the
    # pod table can show wait-vs-target per job at a glance
    for j, slo in REGISTRY.sum_by(SERVICE_JOB_SLO_METRIC, "job").items():
        if j and slo and j in jobs:
            jobs[j]["slo_wait_frac"] = round(slo, 4)
    return {
        "telemetry_schema_version": SCHEMA_VERSION,
        "stages": {k: round(v, 4) for k, v in stages.items() if k},
        "resilience": {k: int(round(v)) for k, v in events.items() if k},
        "jobs": jobs,
        # tiered artifact store (docs/store.md): this host's live bytes
        # under management + its eviction/rebuild tallies, so the pod
        # table shows which rank's disk the budget is squeezing
        "store": {
            "store_bytes": int(REGISTRY.sum(STORE_BYTES_METRIC)),
            "store_evictions": int(round(
                events.get("store_evictions", 0))),
            "store_rebuilds_after_eviction": int(round(
                events.get("store_rebuilds_after_eviction", 0))),
        },
        "spans": span_counts(),
        "spans_dropped": spans_dropped(),
        # control-decision ledger summary (schema v2): component.action
        # tallies, so the pod table shows every rank's control activity
        # next to the stage seconds it acted on
        "decisions": decision_counts(),
    }


def _format_jobs_cell(jobs: dict) -> str:
    """One rank's per-job breakdown cell: ``job=wait<seconds>s/parts<n>``
    per job (docs/observability.md per-job pod-table rows)."""
    cells = []
    for j in sorted(jobs):
        rec = jobs[j] or {}
        cell = (f"{j}=wait{float(rec.get('input_wait_seconds', 0.0)):.3f}s"
                f"/parts{int(rec.get('parts', 0))}")
        if rec.get("slo_wait_frac"):
            # the job's input-wait SLO target next to its wait — the
            # at-a-glance "is the autoscaler holding the contract" cell
            cell += f"/slo{float(rec['slo_wait_frac']):.2f}"
        cells.append(cell)
    return " ".join(cells) if cells else "-"


def format_pod_table(by_rank: Dict[int, dict]) -> str:
    """Merged per-rank × per-stage seconds table from worker snapshots
    (what the tracker logs), with a trailing per-job breakdown column
    (job-labeled input wait + parts served — the fleet autoscaler's
    operator-visible input signal). Ranks whose snapshot carries a
    different schema version are listed but not merged."""
    stage_cols = list(STAGES)
    extras = sorted({s for snap in by_rank.values()
                     for s in (snap.get("stages") or {})
                     if s not in STAGES})
    stage_cols += extras
    width = max([5] + [len(s) for s in stage_cols])
    header = "rank  " + "  ".join(f"{s:>{width}}" for s in stage_cols) \
        + "  resilience  jobs  decisions"
    lines = [header]
    totals = {s: 0.0 for s in stage_cols}
    job_totals: Dict[str, Dict[str, float]] = {}
    decision_totals: Dict[str, int] = {}
    for rank in sorted(by_rank):
        snap = by_rank[rank] or {}
        if snap.get("telemetry_schema_version") != SCHEMA_VERSION:
            lines.append(f"{rank:>4}  [schema "
                         f"{snap.get('telemetry_schema_version')!r} != "
                         f"{SCHEMA_VERSION}: not merged]")
            continue
        stages = snap.get("stages") or {}
        cells = []
        for s in stage_cols:
            v = float(stages.get(s, 0.0))
            totals[s] += v
            cells.append(f"{v:>{width}.3f}")
        res = snap.get("resilience") or {}
        hot = {k: v for k, v in sorted(res.items()) if v}
        # store_evictions/rebuilds already ride the resilience dict;
        # surface the rank's live store bytes next to them when nonzero
        store_bytes = (snap.get("store") or {}).get("store_bytes")
        if store_bytes:
            hot["store_bytes"] = int(store_bytes)
        jobs = snap.get("jobs") or {}
        for j, rec in jobs.items():
            tot = job_totals.setdefault(j, {"input_wait_seconds": 0.0,
                                            "parts": 0})
            tot["input_wait_seconds"] += float(
                (rec or {}).get("input_wait_seconds", 0.0))
            tot["parts"] += int((rec or {}).get("parts", 0))
            slo = (rec or {}).get("slo_wait_frac")
            if slo:
                # a target, not a tally: identical across ranks, so the
                # sum row carries it through max, never addition
                tot["slo_wait_frac"] = max(float(slo),
                                           float(tot.get("slo_wait_frac",
                                                         0.0)))
        # control-decision tallies (schema v2): every autoscale / evict /
        # hedge / throttle this rank performed, as component.action:n
        decisions = snap.get("decisions") or {}
        for d, n in decisions.items():
            decision_totals[d] = decision_totals.get(d, 0) + int(n)
        dec_cell = " ".join(f"{d}:{int(n)}" for d, n in
                            sorted(decisions.items()) if n) or "-"
        lines.append(f"{rank:>4}  " + "  ".join(cells)
                     + f"  {hot if hot else '-'}"
                     + f"  {_format_jobs_cell(jobs)}"
                     + f"  {dec_cell}")
    lines.append("-" * len(header))
    lines.append(" sum  " + "  ".join(
        f"{totals[s]:>{width}.3f}" for s in stage_cols)
        + (f"  jobs: {_format_jobs_cell(job_totals)}"
           if job_totals else "")
        + ("  decisions: " + " ".join(
            f"{d}:{n}" for d, n in sorted(decision_totals.items()) if n)
           if decision_totals else ""))
    return "\n".join(lines)


def component_snapshot(role: str) -> dict:
    """Everything ONE component ships for a merged pod timeline — the
    ``trace_dump`` RPC reply body on dispatcher and workers, and what
    ``LocalFleet.dump_trace`` collects locally. ``now`` is this
    process's monotonic clock at snapshot time: the puller pairs it with
    its own RPC request/reply midpoint to estimate the peer's clock
    offset (docs/observability.md Distributed tracing)."""
    return {"peer": str(role), "pid": os.getpid(),
            "schema": SCHEMA_VERSION, "now": round(time.monotonic(), 6),
            "spans": spans_snapshot(), "decisions": decisions_snapshot()}


def export_pod_trace(path: str, peers: List[dict]) -> int:
    """Merge per-peer span + decision snapshots into ONE Chrome-trace/
    Perfetto JSON — the fleet-wide timeline (docs/observability.md
    Distributed tracing). Each peer dict carries:

    - ``peer``: display name (``dispatcher``, ``worker-0``, ``client``,
      ``rank-3``...) — becomes the Perfetto process name, so pid = role
    - ``schema``: the peer's ``telemetry_schema_version``
    - ``clock_offset_s``: seconds to ADD to the peer's timestamps to
      land them on the caller's clock (estimated from RPC request/reply
      midpoints — see ``LocalFleet.dump_trace``); 0.0 for local spans
    - ``spans``: :func:`spans_snapshot` rows
    - ``decisions``: :func:`decisions_snapshot` events, rendered as
      instant events on the peer's timeline

    A peer at a DIFFERENT schema version is listed, never merged: its
    process shows up with one explicit ``schema-mismatch`` annotation
    instant event and none of its spans — the same refuse-to-merge
    contract as :func:`format_pod_table`, so a mixed-version fleet
    degrades loudly instead of rendering garbage. Returns the number of
    span events written; the file is written to ``<path>.tmp`` then
    atomically published."""
    events: List[dict] = []
    written = 0
    skipped_peers: List[str] = []
    for pid, peer in enumerate(peers, start=1):
        name = str(peer.get("peer") or f"peer-{pid}")
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "tid": 0, "args": {"name": name}})
        schema = peer.get("schema")
        offset_us = float(peer.get("clock_offset_s") or 0.0) * 1e6
        if schema != SCHEMA_VERSION:
            # listed, not merged: one loud annotation, zero spans
            skipped_peers.append(name)
            events.append({
                "name": "schema-mismatch", "cat": "dmlc_tpu", "ph": "i",
                "pid": pid, "tid": 0, "ts": 0.0, "s": "p",
                "args": {"schema": schema, "expected": SCHEMA_VERSION,
                         "note": "peer listed, spans not merged"},
            })
            continue
        threads_named = set()
        for s in peer.get("spans") or []:
            tid = s.get("tid", 0)
            if tid not in threads_named:
                threads_named.add(tid)
                events.append({"name": "thread_name", "ph": "M",
                               "pid": pid, "tid": tid,
                               "args": {"name": s.get("thread", "")}})
            args = dict(s.get("labels") or {})
            if s.get("pipeline"):
                args["pipeline"] = s["pipeline"]
            for k in ("trace_id", "parent_id", "span_id"):
                if s.get(k):
                    args[k] = s[k]
            events.append({
                "name": s["name"], "cat": "dmlc_tpu", "ph": "X",
                "pid": pid, "tid": tid,
                "ts": s["start_ns"] / 1e3 + offset_us,
                "dur": s["dur_ns"] / 1e3,
                "args": args,
            })
            written += 1
        for d in peer.get("decisions") or []:
            events.append({
                "name": f"{d.get('component', '?')}.{d.get('action', '?')}",
                "cat": "dmlc_tpu_decision", "ph": "i", "pid": pid,
                "tid": 0, "ts": float(d.get("ts", 0.0)) * 1e6 + offset_us,
                "s": "p", "args": dict(d),
            })
    doc = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "telemetry_schema_version": SCHEMA_VERSION,
            "peers": [str(p.get("peer") or "") for p in peers],
            "peers_not_merged": skipped_peers,
        },
    }
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)
    return written
