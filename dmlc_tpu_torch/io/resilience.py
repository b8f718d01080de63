"""The restart budget of a pipeline, and the resilience event counters.

Own copy of the JAX package's rule (``io/resilience.py``:
``RetryPolicy.from_env`` and ``restart_verdict``), trimmed to what the port
uses: ``DMLC_RETRY_MAX_ATTEMPTS`` (default 4) counts the attempts one
operation may make, so a pipeline may restart ``max_attempts - 1`` times in
an epoch before the error propagates. ``DMLC_RETRY_MAX_ATTEMPTS=1`` allows
no restart. The JAX package also sleeps a jittered backoff before each
restart; the port's one restart cause, a corrupt snapshot batch, has nothing
to wait for, so it does not.

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
``snapshot_invalidations``; the retry, resume and giveup keys read 0 until
the port has the filesystems that retry.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

from dmlc_tpu_torch.utils import telemetry as _telemetry

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


def max_attempts_from_env() -> int:
    """``DMLC_RETRY_MAX_ATTEMPTS``, at least 1 (unset or empty: 4)."""
    return max(1, int(os.environ.get("DMLC_RETRY_MAX_ATTEMPTS", "4") or 4))


def restart_allowed(used: int, max_attempts: int) -> bool:
    """Whether a pipeline that has restarted ``used`` times may restart again."""
    return used < max(0, max_attempts - 1)
