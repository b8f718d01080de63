"""Wall-clock timing — analog of dmlc::GetTime (timer.h:27)."""

from __future__ import annotations

import time


def get_time() -> float:
    """Seconds, monotonic."""
    return time.monotonic()
