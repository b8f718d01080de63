"""The restart budget of a pipeline, and the resilience event counters.

Own copy of the JAX package's rule (``io/resilience.py``:
``RetryPolicy.from_env`` and ``restart_verdict``), trimmed to what the port
uses: ``DMLC_RETRY_MAX_ATTEMPTS`` (default 4) counts the attempts one
operation may make, so a pipeline may restart ``max_attempts - 1`` times in
an epoch before the error propagates. ``DMLC_RETRY_MAX_ATTEMPTS=1`` allows
no restart. The JAX package also sleeps a jittered backoff before each
restart; the port's one restart cause, a corrupt snapshot batch, has nothing
to wait for, so it does not.

The counters are the JAX package's process-wide event totals under its
names (``record_event``, ``counters_snapshot``, ``counters_delta``), for
the events the port records: ``cache_corruptions`` (a block-cache block
failed its crc32), ``cache_rebuilds`` (the cache was rebuilt from the
source) and ``cache_invalidations`` (a stale or unreadable cache was
dropped). The JAX package's per-pipeline labels are not ported.
"""

from __future__ import annotations

import os
import threading
from typing import Dict

# the events the port records; a snapshot reports each, zero included
EVENT_KEYS = ("cache_corruptions", "cache_rebuilds", "cache_invalidations")
_counts: Dict[str, int] = {k: 0 for k in EVENT_KEYS}
_lock = threading.Lock()


def record_event(key: str, n: int = 1) -> None:
    """Count ``n`` resilience events ``key``, process-wide."""
    with _lock:
        _counts[key] = _counts.get(key, 0) + int(n)


def counters_snapshot() -> Dict[str, int]:
    """The process-wide totals by event key."""
    with _lock:
        return dict(_counts)


def counters_delta(base: Dict[str, int]) -> Dict[str, int]:
    """The events counted since ``base``, a :func:`counters_snapshot`."""
    return {k: v - base.get(k, 0) for k, v in counters_snapshot().items()}


def max_attempts_from_env() -> int:
    """``DMLC_RETRY_MAX_ATTEMPTS``, at least 1 (unset or empty: 4)."""
    return max(1, int(os.environ.get("DMLC_RETRY_MAX_ATTEMPTS", "4") or 4))


def restart_allowed(used: int, max_attempts: int) -> bool:
    """Whether a pipeline that has restarted ``used`` times may restart again."""
    return used < max(0, max_attempts - 1)
