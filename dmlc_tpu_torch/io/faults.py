"""Deterministic, seedable fault injection for the I/O stack.

Own copy of the JAX package's ``io/faults.py``: the same grammar, error
classes, occurrence counting and ``DMLC_FAULT_PLAN`` hook, so one plan
fires at the same calls in both packages. ``corrupt`` builds this
package's :class:`~dmlc_tpu_torch.utils.check.CacheCorruptionError` and a
bad clause this package's ``DMLCError``, which the port's ``classify`` and
healing paths recognise.

Every guarded network attempt in the package (each
``RetryPolicy.call`` attempt — stream fetches, metadata requests,
writes) passes through :func:`maybe_fail` before touching the transport.
An active :class:`FaultPlan` can therefore fail the Nth read / open /
request / connect with a chosen error CLASS — the real exception types
(``urllib.error.HTTPError``, ``ConnectionResetError``, ``TimeoutError``,
``urllib.error.URLError``) — so every retry / resume / give-up /
fail-fast path is exercised in tier-1 tests with zero network egress.

Plan grammar (``;``-separated clauses)::

    clause     := op ['~' substr] '@' occurrence ['=' error]
    op         := 'read' | 'open' | 'write' | 'request' | 'connect' | ...
    occurrence := N | N '..' M | N '+'        (1-based, per clause)
    error      := 'http-<code>' | 'reset' | 'timeout' | 'unreachable'
                  | 'corrupt' | 'conn' | 'torn'   (default: 'http-503')

The op is the call-site label passed to ``maybe_fail``: ``read`` fires on
stream block fetches, ``open`` on metadata/stat/open requests, ``write``
on upload requests, ``request`` on other control requests, and
``connect`` on EVERY guarded attempt regardless of label (the lowest
seam). ``cache_read`` fires on cache-frame/segment reads (the chunk cache
and the block cache) and ``snapshot_read`` on snapshot batch reads, where
the natural error class is ``corrupt`` — a
:class:`~dmlc_tpu_torch.utils.check.CacheCorruptionError` that exercises the
drop-cache/re-parse/rewrite healing path without touching bytes on disk.
The control-plane ops cover the data service (docs/service.md):
``dispatch_rpc`` fires on every dispatcher round trip (workers, clients,
fleet bootstrap — the seam sits inside ``service.dispatcher.request``)
and ``worker_rpc`` on client->worker connections (stream / find /
count). Their natural error classes are ``conn`` (connection refused —
the peer is down, e.g. a dispatcher between kill and restart) and
``torn`` (the peer died mid-reply), both retryable, so chaos plans
drive dispatcher-restart and torn-reply-storm paths deterministically.
``preempt`` is the elastic-membership seam: every parse worker checks it
once per heartbeat with its worker id as the subject, and ANY firing —
whatever error class the clause names — is consumed as a preemption
notice (``preemption_notices``) that begins a graceful drain rather than
surfacing as an exception, so rolling-preemption chaos is one plan away
(``preempt~rank0@1``).
``~substr`` restricts a clause to calls whose subject (URL/path)
contains the substring; occurrences are counted per clause over its
matching calls only, so plans are deterministic under interleaving from
other streams.

Examples::

    read@1..2=http-503      # first two block reads answer 503, then heal
    open~part-3@1=http-403  # opening part-3 fails fatally once
    read@4=reset            # the 4th read dies with a connection reset
    connect@2+=timeout      # every guarded attempt from the 2nd on hangs
    dispatch_rpc@2..4=conn  # dispatcher unreachable for three round trips
    worker_rpc@1=torn       # first client->worker exchange dies mid-reply
    preempt~rank0@1         # worker rank0 gets a preemption notice: drains

Activate with the :func:`inject` context manager, or process-wide with
``DMLC_FAULT_PLAN`` (the env hook — read lazily on the first guarded
call, re-parsed whenever the value changes). See docs/resilience.md.
"""

from __future__ import annotations

import email.message
import io as _pyio
import os
import re
import threading
import urllib.error
from contextlib import contextmanager
from typing import List, Optional

from dmlc_tpu_torch.utils.check import CacheCorruptionError, DMLCError

_CLAUSE_RE = re.compile(
    r"^(?P<op>[A-Za-z_][\w-]*)"
    r"(?:~(?P<substr>[^@]*))?"
    r"@(?P<lo>\d+)(?:(?P<range>\.\.(?P<hi>\d+))|(?P<plus>\+))?"
    r"(?:=(?P<err>[\w-]+))?$"
)


def _build_error(spec: str, what: str) -> BaseException:
    if spec.startswith("http-"):
        code = int(spec[5:])
        hdrs = email.message.Message()
        return urllib.error.HTTPError(
            what or "fault://injected", code,
            f"injected http {code}", hdrs, _pyio.BytesIO(b""))
    if spec == "reset":
        return ConnectionResetError(104, "injected connection reset")
    if spec == "timeout":
        return TimeoutError("injected timeout")
    if spec == "unreachable":
        return urllib.error.URLError(OSError("injected: host unreachable"))
    if spec == "corrupt":
        return CacheCorruptionError(
            f"injected cache corruption: {what or 'fault://injected'}")
    if spec == "conn":
        return ConnectionRefusedError(
            111, f"injected: connection refused: "
                 f"{what or 'fault://injected'}")
    if spec == "torn":
        return ConnectionError(
            f"injected: torn reply from {what or 'fault://injected'}")
    raise DMLCError(f"fault plan: unknown error class {spec!r}")


class _Clause:
    __slots__ = ("op", "substr", "lo", "hi", "err", "calls", "fired")

    def __init__(self, op: str, substr: Optional[str], lo: int,
                 hi: Optional[int], err: str):
        self.op = op
        self.substr = substr
        self.lo = lo
        self.hi = hi  # None = open-ended ('N+')
        self.err = err
        self.calls = 0  # matching calls seen
        self.fired = 0  # faults actually raised

    def matches(self, op: str, what: str) -> bool:
        return op == self.op and (not self.substr or self.substr in what)

    def due(self) -> bool:
        if self.hi is None:
            return self.calls >= self.lo
        return self.lo <= self.calls <= self.hi


class FaultPlan:
    """A parsed fault plan with its (thread-safe) occurrence counters."""

    def __init__(self, spec: str):
        self.spec = spec
        self._lock = threading.Lock()
        self._clauses: List[_Clause] = []
        for raw in spec.split(";"):
            raw = raw.strip()
            if not raw:
                continue
            m = _CLAUSE_RE.match(raw)
            if m is None:
                raise DMLCError(
                    f"fault plan: bad clause {raw!r} "
                    f"(expected op[~substr]@N[..M|+][=error])")
            lo = int(m.group("lo"))
            hi = int(m.group("hi")) if m.group("hi") else (
                None if m.group("plus") else lo)
            err = m.group("err") or "http-503"
            _build_error(err, "")  # validate the error class at parse time
            self._clauses.append(
                _Clause(m.group("op"), m.group("substr"), lo, hi, err))

    def check(self, op: str, what: str = "") -> Optional[BaseException]:
        """Count this call against every matching clause; return the error
        to raise if one is due (first matching clause wins)."""
        due: Optional[_Clause] = None
        with self._lock:
            for clause in self._clauses:
                if not clause.matches(op, what):
                    continue
                clause.calls += 1
                if due is None and clause.due():
                    clause.fired += 1
                    due = clause
        if due is None:
            return None
        return _build_error(due.err, what)

    def fired(self) -> int:
        """Total faults injected so far (all clauses)."""
        with self._lock:
            return sum(c.fired for c in self._clauses)


# active plan: module-global so pipeline/producer threads see it too
_active: Optional[FaultPlan] = None
_env_cache: Optional[FaultPlan] = None  # lazily parsed DMLC_FAULT_PLAN


def active_plan() -> Optional[FaultPlan]:
    """The plan guarding calls right now: an :func:`inject` plan if one is
    open, else the (cached) ``DMLC_FAULT_PLAN`` env plan, else None."""
    global _env_cache
    if _active is not None:
        return _active
    spec = os.environ.get("DMLC_FAULT_PLAN")
    if not spec:
        _env_cache = None
        return None
    if _env_cache is None or _env_cache.spec != spec:
        _env_cache = FaultPlan(spec)
    return _env_cache


def maybe_fail(op: str, what: str = "") -> None:
    """The injection seam: raise the planned error for this call, if any.

    Called with the call-site label and subject (URL/path) before every
    guarded I/O attempt. No-op (two dict reads) when no plan is active.
    """
    plan = active_plan()
    if plan is None:
        return
    exc = plan.check(op, str(what))
    if exc is not None:
        raise exc


@contextmanager
def inject(plan):
    """Activate a fault plan for the dynamic extent of the block.

    ``plan`` is a :class:`FaultPlan` or a spec string. Yields the plan (its
    ``fired()`` count lets tests assert exact injected-fault totals).
    Nests: the previous plan is restored on exit.
    """
    global _active
    if not isinstance(plan, FaultPlan):
        plan = FaultPlan(str(plan))
    prev = _active
    _active = plan
    try:
        yield plan
    finally:
        _active = prev


def reset() -> None:
    """Drop any active/env-cached plan state (test isolation)."""
    global _active, _env_cache
    _active = None
    _env_cache = None
