"""Error type, CHECK helper and logger for the PyTorch port.

Own copy of the JAX package's ``utils/check.py`` (the port imports nothing
of it), trimmed to what the port uses: :class:`DMLCError`,
:class:`CacheCorruptionError`, :func:`check` with its comparison forms
(:func:`check_eq` … :func:`check_ge`, their messages the JAX package's)
and :func:`get_logger`.
"""

from __future__ import annotations

import logging
import os
import sys


class DMLCError(RuntimeError):
    """Raised by failed checks — analog of ``dmlc::Error`` (logging.h:29)."""


class CacheCorruptionError(DMLCError):
    """An on-disk container failed its integrity check (a batch's crc32
    does not match). The owner drops the file; the next pass rebuilds it
    from the source."""


_LOGGER: logging.Logger | None = None


def get_logger() -> logging.Logger:
    """Process-wide logger; level gated by DMLC_LOG_DEBUG like logging.h:131-146."""
    global _LOGGER
    if _LOGGER is None:
        logger = logging.getLogger("dmlc_tpu_torch")
        if not logger.handlers:
            handler = logging.StreamHandler(sys.stderr)
            handler.setFormatter(
                logging.Formatter("[%(asctime)s] %(levelname)s %(name)s: %(message)s")
            )
            logger.addHandler(handler)
        debug = os.environ.get("DMLC_LOG_DEBUG", "0") not in ("", "0", "false", "False")
        logger.setLevel(logging.DEBUG if debug else logging.INFO)
        _LOGGER = logger
    return _LOGGER


def check(cond: bool, msg: str = "check failed") -> None:
    """``CHECK(cond)`` — reference logging.h:205."""
    if not cond:
        raise DMLCError(msg)


def _fail(detail: str, msg: str) -> None:
    raise DMLCError(f"{detail}: {msg}" if msg else detail)


def check_eq(a, b, msg: str = "") -> None:
    if not (a == b):
        _fail(f"check failed: {a!r} == {b!r}", msg)


def check_ne(a, b, msg: str = "") -> None:
    if not (a != b):
        _fail(f"check failed: {a!r} != {b!r}", msg)


def check_lt(a, b, msg: str = "") -> None:
    if not (a < b):
        _fail(f"check failed: {a!r} < {b!r}", msg)


def check_le(a, b, msg: str = "") -> None:
    if not (a <= b):
        _fail(f"check failed: {a!r} <= {b!r}", msg)


def check_gt(a, b, msg: str = "") -> None:
    if not (a > b):
        _fail(f"check failed: {a!r} > {b!r}", msg)


def check_ge(a, b, msg: str = "") -> None:
    if not (a >= b):
        _fail(f"check failed: {a!r} >= {b!r}", msg)
