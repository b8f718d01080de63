"""Stream factory — analog of reference ``Stream::Create(uri, flag)``
(io.h:57, src/io.cc:132) and ``SeekStream::CreateForRead`` (io.h:127).

Own copy of the JAX package's ``io/stream.py``. Python file objects
already have the Stream interface (read, write, seek, tell, close); this
module is the URI-dispatching factory over the filesystem registry
(:mod:`dmlc_tpu_torch.io.filesystem`) and two whole-file helpers.
"""

from __future__ import annotations

import io as _pyio
from typing import BinaryIO

from dmlc_tpu_torch.io.filesystem import get_filesystem
from dmlc_tpu_torch.io.resilience import ResilientStream
from dmlc_tpu_torch.io.uri import URI
from dmlc_tpu_torch.utils.check import DMLCError


def open_stream(uri: str, mode: str = "r", allow_null: bool = False,
                resilient: bool = False) -> BinaryIO | None:
    """A binary stream for ``uri`` — analog of Stream::Create (src/io.cc:132).

    ``mode``: ``r`` read, ``w`` write, ``a`` append. With ``allow_null``,
    a target that cannot be opened gives None instead of raising (io.h:57).

    ``resilient=True`` (reads only) wraps the stream in
    :class:`~dmlc_tpu_torch.io.resilience.ResilientStream`: a retryable
    mid-read failure reopens the source and resumes at the current byte
    offset. A filesystem whose streams resume by themselves
    (``native_resilience``) is not wrapped, so no second retry budget is
    stacked on its own.
    """
    if mode not in ("r", "w", "a"):
        raise DMLCError(f"open_stream: bad mode {mode!r}")
    parsed = URI(uri)
    try:
        fs = get_filesystem(parsed)
        if resilient and mode == "r" and not getattr(fs, "native_resilience", False):
            return _pyio.BufferedReader(ResilientStream(lambda: fs.open(parsed, "r"), what=uri))
        return fs.open(parsed, mode)
    except DMLCError:
        if allow_null:
            return None
        raise


def read_all(uri: str) -> bytes:
    with open_stream(uri, "r") as f:
        return f.read()


def write_all(uri: str, data: bytes) -> None:
    with open_stream(uri, "w") as f:
        f.write(data)
