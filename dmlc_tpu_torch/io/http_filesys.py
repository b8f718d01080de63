"""HTTP(S) read-only filesystem over Range requests.

Own copy of the JAX package's ``io/http_filesys.py``: the reference's
http(s):// read support, which lives in its S3 module
(s3_filesys.cc CURLReadStreamBase: ``Range: bytes=N-`` GETs, a restart on
seek, s3_filesys.cc:498-701), as a buffered block reader on urllib.

:class:`HttpReadStream` reads ahead in blocks of :data:`_BLOCK` (1 MiB).
Every block goes through the shared :class:`~dmlc_tpu_torch.io.resilience.RetryPolicy`
(``op="read"``, ``resume_offset`` the block's start): a transient fault
(5xx, 429 with its ``Retry-After`` as the backoff floor, 408, a reset
connection, a timeout) is retried, and a retried block re-requests the same
byte range, so the reader resumes mid-file at its exact offset; a fatal
one (403, a malformed URI) raises after one attempt. A server that answers
a Range request with 200 and the whole body gives the reader its whole
buffer (never fetched again), and a 416 is the end of the file. The cloud
streams (``s3://``, ``gs://``, ``hdfs://``, ``azure://``) subclass it and
replace only the one attempt, :meth:`HttpReadStream._fetch`.
"""

from __future__ import annotations

import io as _pyio
import urllib.error
import urllib.request
from typing import List, Optional

from dmlc_tpu_torch.io.filesystem import FILE_TYPE, FileInfo, FileSystem, register_filesystem
from dmlc_tpu_torch.io.resilience import RetryPolicy, default_policy
from dmlc_tpu_torch.io.uri import URI
from dmlc_tpu_torch.utils.check import DMLCError

_BLOCK = 1 << 20  # the read-ahead block


class HttpReadStream(_pyio.RawIOBase):
    """A seekable read-only stream over HTTP Range requests."""

    def __init__(self, url: str, size: Optional[int] = None,
                 policy: Optional[RetryPolicy] = None):
        super().__init__()
        self.url = url
        self._policy = policy or default_policy()
        self._pos = 0
        self._size = size if size is not None else _content_length(url, self._policy)
        self._buf = b""
        self._buf_start = 0

    def readable(self) -> bool:
        return True

    def seekable(self) -> bool:
        return True

    def seek(self, offset: int, whence: int = 0) -> int:
        if whence == 0:
            self._pos = offset
        elif whence == 1:
            self._pos += offset
        elif whence == 2:
            self._pos = self._size + offset
        return self._pos

    def tell(self) -> int:
        return self._pos

    def _fetch(self, start: int, end: int) -> bytes:
        """One attempt at bytes ``[start, end)``: a transport error is
        raised as it is (a 416 is the end of the file), for
        :meth:`_fetch_retry` to classify."""
        req = urllib.request.Request(self.url, headers={"Range": f"bytes={start}-{end - 1}"})
        try:
            with urllib.request.urlopen(req, timeout=self._policy.attempt_timeout) as resp:
                body = resp.read()
                if resp.status == 206:
                    return body
                # the server ignored the Range header and sent the whole
                # file: keep it as the buffer, so it never crosses again
                self._buf = body
                self._buf_start = 0
                return body[start:end]
        except urllib.error.HTTPError as exc:
            if exc.code == 416:
                return b""
            raise

    def _fetch_retry(self, start: int, end: int) -> bytes:
        """A block under the retry budget; a retry at ``start > 0`` counts
        as a mid-stream resume (it re-requests the same range)."""
        return self._policy.call(lambda: self._fetch(start, end), op="read", what=self.url,
                                 resume_offset=start)

    def readinto(self, b) -> int:
        data = self.read(len(b))
        b[: len(data)] = data
        return len(data)

    def read(self, n: int = -1) -> bytes:
        if n is None or n < 0:
            n = max(self._size - self._pos, 0)
        if n == 0 or self._pos >= self._size:
            return b""
        out = bytearray()
        while n > 0 and self._pos < self._size:
            buf_off = self._pos - self._buf_start
            if 0 <= buf_off < len(self._buf):
                take = min(n, len(self._buf) - buf_off)
                out += self._buf[buf_off:buf_off + take]
                self._pos += take
                n -= take
                continue
            start = self._pos
            end = min(start + max(_BLOCK, n), self._size)
            fetched = self._fetch_retry(start, end)
            if not fetched:
                break
            # a 200 answer installed the whole body as the buffer already
            if not (self._buf_start == 0 and len(self._buf) == self._size):
                self._buf = fetched
                self._buf_start = start
        return bytes(out)


def _content_length(url: str, policy: Optional[RetryPolicy] = None) -> int:
    policy = policy or default_policy()

    def attempt() -> int:
        req = urllib.request.Request(url, method="HEAD")
        with urllib.request.urlopen(req, timeout=policy.attempt_timeout) as resp:
            length = resp.headers.get("Content-Length")
            if length is None:
                raise DMLCError(f"http: no Content-Length for {url}")
            return int(length)

    return policy.call(attempt, op="open", what=url)


class HttpFileSystem(FileSystem):
    """Read-only ``http://`` / ``https://`` files, no listing (as in the
    reference: read streams only)."""

    native_resilience = True  # HttpReadStream resumes at the failed offset

    _instance: Optional["HttpFileSystem"] = None

    @classmethod
    def instance(cls, uri: Optional[URI] = None) -> "HttpFileSystem":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def get_path_info(self, path: URI) -> FileInfo:
        return FileInfo(path, _content_length(str(path)), FILE_TYPE)

    def list_directory(self, path: URI) -> List[FileInfo]:
        raise DMLCError("http filesystem does not support directory listing")

    def open(self, path: URI, mode: str):
        if mode != "r":
            raise DMLCError("http filesystem is read-only")
        return _pyio.BufferedReader(HttpReadStream(str(path)))


register_filesystem("http://", HttpFileSystem.instance)
register_filesystem("https://", HttpFileSystem.instance)
