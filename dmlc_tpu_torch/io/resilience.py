"""The restart budget of a pipeline.

Own copy of the JAX package's rule (``io/resilience.py``:
``RetryPolicy.from_env`` and ``restart_verdict``), trimmed to what the port
uses: ``DMLC_RETRY_MAX_ATTEMPTS`` (default 4) counts the attempts one
operation may make, so a pipeline may restart ``max_attempts - 1`` times in
an epoch before the error propagates. ``DMLC_RETRY_MAX_ATTEMPTS=1`` allows
no restart. The JAX package also sleeps a jittered backoff before each
restart; the port's one restart cause, a corrupt snapshot batch, has nothing
to wait for, so it does not.
"""

from __future__ import annotations

import os


def max_attempts_from_env() -> int:
    """``DMLC_RETRY_MAX_ATTEMPTS``, at least 1 (unset or empty: 4)."""
    return max(1, int(os.environ.get("DMLC_RETRY_MAX_ATTEMPTS", "4") or 4))


def restart_allowed(used: int, max_attempts: int) -> bool:
    """Whether a pipeline that has restarted ``used`` times may restart again."""
    return used < max(0, max_attempts - 1)
