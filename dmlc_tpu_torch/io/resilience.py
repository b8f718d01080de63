"""The fault-tolerance rules of the I/O stack, and the resilience counters.

Own copy of the JAX package's ``io/resilience.py`` but its
fault-injection seam (``faults.maybe_fail``, no fault plans in the port):

- :func:`classify` names an exception ``retryable`` (5xx / 429 / 408,
  a reset or refused connection, a timeout, a corrupt cache) or ``fatal``
  (everything else), through its ``__cause__`` chain;
  :func:`retry_after_seconds` reads a ``Retry-After`` floor;
- :class:`RetryPolicy`: exponential backoff with full jitter, a deadline,
  the ``DMLC_RETRY_*`` environment (:meth:`RetryPolicy.from_env`,
  :func:`default_policy`); ``DMLC_RETRY_MAX_ATTEMPTS`` (default 4) counts
  the attempts one operation may make;
- :func:`restart_verdict` / :func:`restart_backoff`: the one budget rule of
  every bounded restart (the pools' ``restart_policy``, ``DeviceIter``'s
  healing): a retryable error may restart ``max_attempts - 1`` times, then
  gives up; ``DMLC_RETRY_MAX_ATTEMPTS=1`` allows no restart. A
  ``DeviceIter`` heals a corrupt snapshot batch without the backoff's
  sleep (nothing to wait for), other retryable errors after it;
- :class:`ResilientStream`: a read stream that reopens its source and
  resumes at its byte offset after a retryable failure
  (``open_stream(uri, resilient=True)``).

The counters are the JAX package's resilience events under its names
(``record_event``, ``counters_snapshot``, ``counters_delta``), each
one registry counter
(:data:`dmlc_tpu_torch.utils.telemetry.REGISTRY`, metric
``resilience_events``) labeled with the event and the pipeline scope
active where it was recorded, so ``pipeline=`` reads one pipeline's
events. A snapshot reports every key of :data:`EVENT_KEYS`, the JAX
package's keys, zero included, and any other event recorded. The port
records ``cache_corruptions`` (a block-cache block failed its crc32),
``cache_rebuilds`` (the cache was rebuilt from the source),
``cache_invalidations`` (a stale or unreadable cache was dropped) and the
snapshot's ``snapshot_corruptions``, ``snapshot_rebuilds`` and
``snapshot_invalidations``; a :class:`ResilientStream` records
``attempts``, ``retries``, ``resumes``, ``giveups`` and ``fatal`` as the
JAX package's does.
"""

from __future__ import annotations

import http.client
import io as _pyio
import os
import random
import time
import urllib.error
from typing import Callable, Dict, Optional

from dmlc_tpu_torch.utils import telemetry as _telemetry
from dmlc_tpu_torch.utils.check import CacheCorruptionError, DMLCError
from dmlc_tpu_torch.utils.timer import get_time

RETRYABLE = "retryable"
FATAL = "fatal"

# HTTP statuses that heal with retry: server-side faults, throttling, and
# request timeout. Everything else 4xx (auth, malformed request, not found)
# is deterministic — retrying it only burns budget and hides the bug.
_RETRYABLE_HTTP = frozenset({408, 429, 500, 502, 503, 504})


def classify(exc: BaseException) -> str:
    """``retryable`` or ``fatal`` for an I/O-stack exception.

    Follows the ``__cause__`` chain so a ``DMLCError`` raised ``from`` a
    transient urllib error stays retryable through wrapper layers (the
    stream-level giveup wraps, the pipeline level still wants the class).
    """
    import ssl

    seen = 0
    while exc is not None and seen < 8:
        if isinstance(exc, CacheCorruptionError):
            # cache faults heal: drop the bad cache, re-read/re-parse the
            # source, rewrite — retryable by construction (the retry IS
            # the rebuild), never a fatal structural error
            return RETRYABLE
        # HTTPError subclasses URLError and OSError: check it first
        if isinstance(exc, urllib.error.HTTPError):
            return (RETRYABLE if exc.code in _RETRYABLE_HTTP
                    or exc.code >= 500 else FATAL)
        if isinstance(exc, urllib.error.URLError):
            # urllib wraps transport failures as URLError(reason) where
            # reason is usually an OSError — gaierror for DNS, EHOSTUNREACH
            # / ECONNREFUSED for routing. All transient at this layer; the
            # one deterministic member is a certificate-verification
            # failure (retrying it only re-fails the handshake).
            if isinstance(exc.reason, ssl.SSLCertVerificationError):
                return FATAL
            return RETRYABLE
        if isinstance(exc, (ConnectionError, TimeoutError)):
            return RETRYABLE  # reset/aborted/refused, socket.timeout
        if isinstance(exc, http.client.HTTPException):
            return RETRYABLE  # IncompleteRead, BadStatusLine, ...
        if isinstance(exc, (DMLCError, OSError)) and exc.__cause__ is not None:
            exc = exc.__cause__
            seen += 1
            continue
        return FATAL
    return FATAL


def retry_after_seconds(exc: BaseException) -> float:
    """Backoff floor from a ``Retry-After`` response header, if any.

    Honors the delta-seconds form (the common throttling shape); an
    HTTP-date or garbage value is ignored rather than parsed — the jittered
    backoff still applies, the floor is just 0.
    """
    seen = 0
    while exc is not None and seen < 8:
        headers = getattr(exc, "headers", None)
        if headers is not None:
            try:
                value = headers.get("Retry-After")
            except AttributeError:
                value = None
            if value is not None:
                try:
                    return max(0.0, float(value))
                except (TypeError, ValueError):
                    return 0.0
        exc = exc.__cause__
        seen += 1
    return 0.0



# the JAX package's event keys; a snapshot reports each, zero included
EVENT_KEYS = ("attempts", "retries", "resumes", "giveups", "fatal",
              "producer_restarts", "producer_giveups",
              "parse_restarts", "parse_giveups",
              "cache_corruptions", "cache_invalidations", "cache_rebuilds",
              "service_retries", "service_failovers", "service_giveups",
              "dispatcher_restarts", "worker_reregistrations",
              "parts_reclaimed", "control_plane_retries",
              "worker_drains", "drain_handoffs", "preemption_notices",
              "speculative_reissues", "speculative_wins", "worker_joins",
              "service_parts_parsed", "service_parts_shared",
              "fleet_scale_ups", "fleet_scale_downs",
              "service_throttles", "service_admission_waits")


def record_event(key: str, n: int = 1) -> None:
    """Count ``n`` events ``key`` under the active pipeline scope."""
    _telemetry.REGISTRY.counter(_telemetry.RESILIENCE_METRIC, event=key,
                                pipeline=_telemetry.current_scope() or "").inc(n)


def counters_snapshot(pipeline: Optional[str] = None) -> Dict[str, int]:
    """The totals by event key: process-wide, or with ``pipeline=`` one
    pipeline's (``""``: the events recorded outside any scope)."""
    label_filter = {} if pipeline is None else {"pipeline": pipeline}
    out = {k: 0 for k in EVENT_KEYS}
    for key, v in _telemetry.REGISTRY.sum_by(_telemetry.RESILIENCE_METRIC, "event",
                                             **label_filter).items():
        if key:
            out[key] = int(round(v))
    return out


def counters_delta(base: Dict[str, int], pipeline: Optional[str] = None) -> Dict[str, int]:
    """The events counted since ``base``, a :func:`counters_snapshot` of
    the same ``pipeline``."""
    now = counters_snapshot(pipeline)
    return {k: v - base.get(k, 0) for k, v in now.items()}


def reset_counters() -> None:
    """Drop every resilience counter (tests)."""
    _telemetry.REGISTRY.clear(_telemetry.RESILIENCE_METRIC)


# ---------------- retry policy ----------------

class RetryPolicy:
    """Exponential backoff + full jitter, per-attempt timeout, deadline.

    One instance describes the budget for ONE logical operation (a request,
    a block fetch): ``max_attempts`` total tries, sleeping
    ``uniform(0, min(max_delay, base_delay * 2**retry))`` between them
    (full jitter — herd-safe), never less than a server-sent
    ``Retry-After``. ``deadline`` bounds the whole operation including
    sleeps; ``attempt_timeout`` is what callers should pass to their
    transport (urlopen timeout=).

    Env knobs (read by :func:`from_env` / :func:`default_policy`):

    ======================================  =======  ========================
    ``DMLC_RETRY_MAX_ATTEMPTS``             4        total attempts per op
    ``DMLC_RETRY_BASE_MS``                  50       first backoff cap (ms)
    ``DMLC_RETRY_MAX_MS``                   5000     backoff cap ceiling (ms)
    ``DMLC_RETRY_DEADLINE_S``               0 (off)  per-op wall deadline
    ``DMLC_RETRY_ATTEMPT_TIMEOUT_S``        60       transport timeout
    ``DMLC_RETRY_SEED``                     unset    seed the jitter rng
    ======================================  =======  ========================
    """

    def __init__(
        self,
        max_attempts: int = 4,
        base_delay: float = 0.05,
        max_delay: float = 5.0,
        deadline: Optional[float] = None,
        attempt_timeout: float = 60.0,
        seed: Optional[int] = None,
        sleep_fn: Optional[Callable[[float], None]] = None,
    ):
        self.max_attempts = max(1, int(max_attempts))
        self.base_delay = max(0.0, float(base_delay))
        self.max_delay = max(self.base_delay, float(max_delay))
        self.deadline = float(deadline) if deadline else None
        self.attempt_timeout = float(attempt_timeout)
        self._rng = random.Random(seed)
        self._sleep = sleep_fn or time.sleep

    @classmethod
    def from_env(cls) -> "RetryPolicy":
        env = os.environ
        seed = env.get("DMLC_RETRY_SEED")
        return cls(
            max_attempts=int(env.get("DMLC_RETRY_MAX_ATTEMPTS", "4") or 4),
            base_delay=float(env.get("DMLC_RETRY_BASE_MS", "50") or 50) / 1e3,
            max_delay=float(env.get("DMLC_RETRY_MAX_MS", "5000") or 5000) / 1e3,
            deadline=float(env.get("DMLC_RETRY_DEADLINE_S", "0") or 0) or None,
            attempt_timeout=float(
                env.get("DMLC_RETRY_ATTEMPT_TIMEOUT_S", "60") or 60),
            seed=int(seed) if seed else None,
        )

    @classmethod
    def none(cls) -> "RetryPolicy":
        """Single attempt, no sleeps — for inner layers whose caller owns
        the retry loop (stacked policies would multiply budgets)."""
        return cls(max_attempts=1)

    def backoff(self, retry_index: int, floor: float = 0.0) -> float:
        """Sleep for the (retry_index+1)-th retry: full-jitter exponential,
        floored by a server-sent Retry-After. The honored floor is capped
        at ``max(30s, max_delay)`` — a misbehaving server advertising
        ``Retry-After: 86400`` must not wedge a reader thread for a day."""
        floor = min(floor, max(30.0, self.max_delay))
        cap = min(self.max_delay, self.base_delay * (2 ** retry_index))
        return max(floor, self._rng.uniform(0.0, cap))

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            self._sleep(seconds)

    def call(
        self,
        fn: Callable[[], object],
        *,
        op: str = "request",
        what: str = "",
        resume_offset: int = 0,
        on_retry: Optional[Callable[[], None]] = None,
    ):
        """Run ``fn`` under this budget.

        Fatal-class errors surface immediately (one attempt); retryable ones sleep and retry until the budget or
        deadline runs out, then raise a ``DMLCError`` chained to the last
        cause. ``resume_offset > 0`` marks retries as mid-stream resumes
        in the counters; ``on_retry`` runs before each re-attempt (e.g.
        drop a broken inner stream).
        """
        t0 = get_time()
        retries = 0
        while True:
            record_event("attempts")
            try:
                return fn()
            except (KeyboardInterrupt, SystemExit, GeneratorExit):
                raise  # control-flow exceptions must never be rewrapped
            except BaseException as exc:  # noqa: BLE001 - classified below
                if classify(exc) != RETRYABLE:
                    record_event("fatal")
                    if isinstance(exc, DMLCError):
                        raise
                    raise DMLCError(
                        f"{op} {what} failed (non-retryable): {exc}") from exc
                delay = self.backoff(retries, floor=retry_after_seconds(exc))
                out_of_budget = retries + 1 >= self.max_attempts
                past_deadline = (
                    self.deadline is not None
                    and get_time() - t0 + delay > self.deadline)
                if out_of_budget or past_deadline:
                    record_event("giveups")
                    why = ("deadline exceeded" if past_deadline
                           else f"retry budget exhausted "
                                f"({self.max_attempts} attempts)")
                    raise DMLCError(
                        f"{op} {what} failed, {why}: {exc}") from exc
                retries += 1
                record_event("retries")
                if resume_offset > 0:
                    record_event("resumes")
                self.sleep(delay)
                if on_retry is not None:
                    on_retry()


def default_policy() -> RetryPolicy:
    """The env-configured policy (fresh read: knobs may change per test)."""
    return RetryPolicy.from_env()


def restart_verdict(policy: Optional[RetryPolicy], used: int,
                    exc: BaseException) -> str:
    """Shared gate for bounded producer/source/pipeline restarts.

    ``'restart'``   retryable class, budget left — consume one unit
    ``'giveup'``    retryable class, budget (``max_attempts - 1``) spent
    ``'propagate'`` fatal class or restarts disabled (``policy is None``)

    The caller owns its instance counters and the repositioning; pair a
    ``'restart'`` with :func:`restart_backoff` before re-arming.
    """
    if policy is None or classify(exc) != RETRYABLE:
        return "propagate"
    if used >= max(0, policy.max_attempts - 1):
        return "giveup"
    return "restart"


def restart_backoff(policy: RetryPolicy, used: int,
                    exc: BaseException) -> None:
    """Sleep the backoff for the (used+1)-th restart, honoring any
    Retry-After the triggering error carried."""
    policy.sleep(policy.backoff(used, floor=retry_after_seconds(exc)))


NO_RETRY = RetryPolicy.none()


# ---------------- the resumable stream ----------------

class ResilientStream(_pyio.RawIOBase):
    """Resumable read-only stream over a reopenable source.

    ``open_fn()`` returns a fresh readable (and seekable, for a mid-stream
    resume) binary stream. On a retryable mid-read failure the broken
    inner stream is dropped, a new one is opened and seeked to the current
    byte offset, and the read resumes: the consumer sees an unbroken byte
    sequence. Fatal errors and spent budgets surface as ``DMLCError``.
    """

    def __init__(self, open_fn: Callable[[], object],
                 policy: Optional[RetryPolicy] = None, what: str = ""):
        super().__init__()
        self._open_fn = open_fn
        self._policy = policy or default_policy()
        self._what = what
        self._inner = None
        self._pos = 0
        self.reopens = 0  # resumes on this stream

    def readable(self) -> bool:
        return True

    def seekable(self) -> bool:
        return True

    def _ensure(self):
        if self._inner is None:
            self._inner = self._open_fn()
            if self._pos:
                self._inner.seek(self._pos)
                self.reopens += 1
        return self._inner

    def _drop_inner(self) -> None:
        inner, self._inner = self._inner, None
        if inner is not None:
            try:
                inner.close()
            except Exception:  # noqa: BLE001 - already broken
                pass

    def seek(self, offset: int, whence: int = 0) -> int:
        self._pos = self._policy.call(
            lambda: self._ensure().seek(offset, whence), op="read", what=self._what,
            resume_offset=self._pos, on_retry=self._drop_inner)
        return self._pos

    def tell(self) -> int:
        return self._pos

    def read(self, n: int = -1) -> bytes:
        data = self._policy.call(
            lambda: self._ensure().read(n), op="read", what=self._what,
            resume_offset=self._pos, on_retry=self._drop_inner)
        if data:
            self._pos += len(data)
        return data

    def readinto(self, b) -> int:
        data = self.read(len(b))
        b[: len(data)] = data
        return len(data)

    def close(self) -> None:
        self._drop_inner()
        super().close()
