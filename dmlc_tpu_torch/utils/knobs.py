"""The port's environment knobs.

A copy of the JAX package's read path (``utils/knobs.py``) for the knobs
the port has so far: an explicit argument wins, then the environment
variable, then the default.

- ``prefetch`` (``DMLC_TPU_PREFETCH``, default 2): batches copied to the
  device ahead of the consumer. An explicit value is clamped up to the
  floor of 1; an environment value that is not a positive integer raises.
- ``device_decode`` (``DMLC_TPU_DEVICE_DECODE``): ``"1"`` arms the device
  decode of warm snapshot batches; any other value, or none, leaves it off.
- ``plan_read_workers`` (``DMLC_TPU_PLAN_READ_WORKERS``, default 2): the
  width of the block cache's plan-ordered read pool, read through
  :func:`resolve` with the JAX package's rules (an explicit value is
  clamped up to 1; an environment value that is not a positive integer
  raises). The JAX package's ceiling, the CPU count, bounds its
  autotuner, which is not ported.
- ``DMLC_TPU_BLOCK_CACHE``: a directory; a parser built without a
  ``block_cache=`` knob or a ``#blockcache=`` fragment caches its blocks
  there under a name derived from the URI (:func:`block_cache_dir`).
"""

from __future__ import annotations

import os
from typing import Optional

from dmlc_tpu_torch.utils.check import DMLCError

PREFETCH_ENV = "DMLC_TPU_PREFETCH"
PREFETCH_DEFAULT = 2
PREFETCH_FLOOR = 1
DEVICE_DECODE_ENV = "DMLC_TPU_DEVICE_DECODE"
BLOCK_CACHE_ENV = "DMLC_TPU_BLOCK_CACHE"
# name -> (env, default, floor)
_KNOBS = {"plan_read_workers": ("DMLC_TPU_PLAN_READ_WORKERS", 2, 1)}


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
    return default


def block_cache_dir() -> Optional[str]:
    """``DMLC_TPU_BLOCK_CACHE``, or None when it is unset or empty."""
    return os.environ.get(BLOCK_CACHE_ENV, "").strip() or None
