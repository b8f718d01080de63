"""The port's environment knobs.

A copy of the JAX package's read path (``utils/knobs.py``) for the knobs
the port has so far: an explicit argument wins, then the environment
variable, then the default.

- ``prefetch`` (``DMLC_TPU_PREFETCH``, default 2): batches copied to the
  device ahead of the consumer. An explicit value is clamped up to the
  floor of 1; an environment value that is not a positive integer raises.
- ``device_decode`` (``DMLC_TPU_DEVICE_DECODE``): ``"1"`` arms the device
  decode of warm snapshot batches; any other value, or none, leaves it off.
- ``parse_workers`` (``DMLC_TPU_PARSE_WORKERS``, default ``max(1, min(4,
  cpus))``): the width of the chunk-parse fan-out
  (``ParallelTextParser``); 1 keeps the one-lane ``ThreadedParser``.
- ``plan_read_workers`` (``DMLC_TPU_PLAN_READ_WORKERS``, default 2): the
  width of the block cache's plan-ordered read pool.
- ``convert_workers`` (``DMLC_TPU_CONVERT_WORKERS``, default 2): the width
  of ``DeviceIter``'s convert pool.
- ``convert_ahead`` (``DMLC_TPU_CONVERT_AHEAD``, default 4): the converted
  batches the convert pool (or the natural-block producer) may hold ahead
  of the consumer.
- ``snapshot_read_workers`` (``DMLC_TPU_SNAPSHOT_READ_WORKERS``, default
  2): the width of the warm snapshot read pool (``SnapshotIter``).

These are read through :func:`resolve` with the JAX package's rules (an
explicit value is clamped up to the floor of 1; an environment value that
is not a positive integer raises). The JAX package's ceilings bound its
autotuner, which is not ported.
- ``DMLC_TPU_TRANSFER_SAMPLE`` (:func:`transfer_sample`, default 32):
  every that many delivered batches ``DeviceIter`` waits for the batch's
  copy and counts the wait; 0 turns the sampling off. Read as the JAX
  ``DeviceIter`` reads it: a value that is not an integer raises
  ``ValueError``, a negative one reads as 0.
- ``DMLC_TPU_TRACE``: the trace mode, read by
  :func:`dmlc_tpu_torch.utils.telemetry.trace_mode`.
- ``DMLC_TPU_BLOCK_CACHE``: a directory; a parser built without a
  ``block_cache=`` knob or a ``#blockcache=`` fragment caches its blocks
  there under a name derived from the URI (:func:`block_cache_dir`).
- ``DMLC_TPU_PARSE_ENGINE``: the text-parse engine (:func:`parse_engine`),
  one of :data:`PARSE_ENGINES`; a typo raises.
"""

from __future__ import annotations

import os
from typing import Optional

from dmlc_tpu_torch.utils.check import DMLCError, check

PREFETCH_ENV = "DMLC_TPU_PREFETCH"
PREFETCH_DEFAULT = 2
PREFETCH_FLOOR = 1
DEVICE_DECODE_ENV = "DMLC_TPU_DEVICE_DECODE"
BLOCK_CACHE_ENV = "DMLC_TPU_BLOCK_CACHE"


def _cpus() -> int:
    return os.cpu_count() or 1


# name -> (env, default, floor); a callable default is read when it is used
_KNOBS = {
    "parse_workers": ("DMLC_TPU_PARSE_WORKERS", lambda: max(1, min(4, _cpus())), 1),
    "plan_read_workers": ("DMLC_TPU_PLAN_READ_WORKERS", 2, 1),
    "convert_workers": ("DMLC_TPU_CONVERT_WORKERS", 2, 1),
    "convert_ahead": ("DMLC_TPU_CONVERT_AHEAD", 4, 1),
    "snapshot_read_workers": ("DMLC_TPU_SNAPSHOT_READ_WORKERS", 2, 1),
}


def _parse_positive_int(raw: str, what: str) -> int:
    try:
        value = int(raw)
    except ValueError:
        raise DMLCError(f"{what}={raw!r}: not an integer; queue depths must be "
                        f"whole numbers >= 1") from None
    if value < 1:
        raise DMLCError(f"{what}={value}: must be >= 1 (unset the variable to use "
                        f"the default instead)")
    return value


def prefetch(explicit: Optional[int] = None) -> int:
    """The prefetch depth: ``explicit`` (clamped up to 1), else
    ``DMLC_TPU_PREFETCH``, else 2."""
    if explicit is not None:
        return max(PREFETCH_FLOOR, int(explicit))
    raw = os.environ.get(PREFETCH_ENV, "").strip()
    if raw:
        return _parse_positive_int(raw, PREFETCH_ENV)
    return PREFETCH_DEFAULT


def device_decode(explicit: Optional[bool] = None) -> bool:
    """The device-decode switch: ``explicit``, else
    ``DMLC_TPU_DEVICE_DECODE == "1"``."""
    if explicit is not None:
        return bool(explicit)
    return os.environ.get(DEVICE_DECODE_ENV, "").strip() == "1"


def resolve(name: str, explicit: Optional[int] = None) -> int:
    """A worker-count knob: ``explicit`` (clamped up to the floor), else
    its environment variable (validated), else the default."""
    if name not in _KNOBS:
        raise DMLCError(f"unknown knob {name!r}; registered knobs: {sorted(_KNOBS)}")
    env, default, floor = _KNOBS[name]
    if explicit is not None:
        return max(floor, int(explicit))
    raw = os.environ.get(env, "").strip()
    if raw:
        return _parse_positive_int(raw, env)
    return int(default() if callable(default) else default)


def transfer_sample(explicit: Optional[int] = None) -> int:
    """The transfer-sample period: ``explicit``, else
    ``DMLC_TPU_TRANSFER_SAMPLE``, else 32; never below 0."""
    if explicit is None:
        explicit = int(os.environ.get("DMLC_TPU_TRANSFER_SAMPLE", "32") or 32)
    return max(0, int(explicit))


def block_cache_dir() -> Optional[str]:
    """``DMLC_TPU_BLOCK_CACHE``, or None when it is unset or empty."""
    return os.environ.get(BLOCK_CACHE_ENV, "").strip() or None


PARSE_ENGINES = ("auto", "native-batch", "native", "python")


def parse_engine(explicit: Optional[str] = None) -> str:
    """The text-parse engine selector (the JAX package's, with its
    message): the explicit argument (``create_parser(engine=)``, else the
    caller passes a ``?engine=`` URI argument here) > ``DMLC_TPU_PARSE_ENGINE``
    > ``auto``. Values:

    - ``auto``: the fused native reader for plain local corpora, the
      registry stack otherwise;
    - ``native-batch``: the chunk-batch parser, which the port does not
      have; it warns and takes the registry stack, as the reference does
      where its batch engine cannot serve;
    - ``native``: the fused native reader only (warns where it cannot
      serve);
    - ``python``: the registry stack on the numpy scanner all the way down.

    A value outside :data:`PARSE_ENGINES` raises."""
    raw = (explicit if explicit is not None
           else os.environ.get("DMLC_TPU_PARSE_ENGINE", "").strip() or "auto")
    value = str(raw).strip().lower()
    check(value in PARSE_ENGINES,
          f"parse engine {raw!r}: must be one of {PARSE_ENGINES} "
          f"(DMLC_TPU_PARSE_ENGINE / create_parser(engine=...) / "
          f"?engine= URI arg — docs/data.md engine-selection table)")
    return value
