"""The port's environment knobs: the two that ``DeviceIter`` reads.

A copy of the JAX package's read path (``utils/knobs.py``) for the knobs
the port has so far: an explicit argument wins, then the environment
variable, then the default.

- ``prefetch`` (``DMLC_TPU_PREFETCH``, default 2): batches copied to the
  device ahead of the consumer. An explicit value is clamped up to the
  floor of 1; an environment value that is not a positive integer raises.
- ``device_decode`` (``DMLC_TPU_DEVICE_DECODE``): ``"1"`` arms the device
  decode of warm snapshot batches; any other value, or none, leaves it off.
"""

from __future__ import annotations

import os
from typing import Optional

from dmlc_tpu_torch.utils.check import DMLCError

PREFETCH_ENV = "DMLC_TPU_PREFETCH"
PREFETCH_DEFAULT = 2
PREFETCH_FLOOR = 1
DEVICE_DECODE_ENV = "DMLC_TPU_DEVICE_DECODE"


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
