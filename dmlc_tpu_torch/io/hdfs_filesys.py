"""HDFS over WebHDFS / HttpFS, in Python alone.

Own copy of the JAX package's ``io/hdfs_filesys.py``. The reference's
client (src/io/hdfs_filesys.cc:10-193) links libhdfs and a JVM; WebHDFS
serves the same namenode semantics over REST (on the namenode's HTTP port,
or through an HttpFS gateway), so urllib covers the reference's surface:

- reads: ``op=OPEN&offset=N&length=M`` ranges through the shared HTTP
  block reader, the ``hdfsPread`` loop's counterpart
  (hdfs_filesys.cc:31-58); the namenode's 307 to a datanode is followed;
- metadata: ``op=GETFILESTATUS`` and ``op=LISTSTATUS``;
- writes: the two-step ``op=CREATE`` (the namenode names the datanode, the
  bytes go there on close);
- auth: ``user.name`` from ``HADOOP_USER_NAME`` / ``USER``, or a
  delegation token from ``HDFS_DELEGATION_TOKEN``.

A URI is ``hdfs://namenode[:port]/path`` (``viewfs://`` too), the port the
namenode's HTTP port (9870 by default); each namenode has its own member,
made from the URI. ``HDFS_WEBHDFS_ENDPOINT`` overrides the endpoint.
"""

from __future__ import annotations

import io as _pyio
import json
import os
import urllib.error
import urllib.parse
import urllib.request
from typing import Dict, List, Optional

from dmlc_tpu_torch.io.filesystem import (DIR_TYPE, FILE_TYPE, FileInfo, FileSystem,
                                          register_filesystem)
from dmlc_tpu_torch.io.http_filesys import HttpReadStream
from dmlc_tpu_torch.io.resilience import RetryPolicy, default_policy
from dmlc_tpu_torch.io.uri import URI
from dmlc_tpu_torch.utils.check import DMLCError, check

_DEFAULT_HTTP_PORT = 9870  # the namenode's HTTP port (Hadoop 3)


class HdfsConfig:
    def __init__(self, uri: Optional[URI] = None) -> None:
        endpoint = os.environ.get("HDFS_WEBHDFS_ENDPOINT")
        if endpoint:
            self.endpoint = endpoint.rstrip("/")
        else:
            check(uri is not None and uri.host,
                  "hdfs:// URI needs a namenode host (hdfs://host[:port]/path)"
                  " or HDFS_WEBHDFS_ENDPOINT")
            host, _, port = uri.host.partition(":")
            self.endpoint = f"http://{host}:{port or _DEFAULT_HTTP_PORT}"
        self.user = os.environ.get("HADOOP_USER_NAME") or os.environ.get("USER")
        self.delegation = os.environ.get("HDFS_DELEGATION_TOKEN")

    def url(self, path: str, op: str, **params: str) -> str:
        query: Dict[str, str] = {"op": op}
        if self.delegation:
            query["delegation"] = self.delegation
        elif self.user:
            query["user.name"] = self.user
        query.update(params)
        if not path.startswith("/"):
            path = "/" + path
        return (f"{self.endpoint}/webhdfs/v1{urllib.parse.quote(path)}?"
                + urllib.parse.urlencode(sorted(query.items())))


def _request(url: str, method: str = "GET", data: Optional[bytes] = None, op: str = "request",
             policy: Optional[RetryPolicy] = None, retry: bool = True):
    """One WebHDFS request under the retry policy; returns the open
    response. A transient status raises as it is, for the classifier; a
    deterministic one raises ``DMLCError`` with the namenode's
    RemoteException message, after one attempt. ``retry=False`` makes one
    attempt (the read stream's budget is its own)."""
    pol = policy or default_policy()

    def attempt():
        req = urllib.request.Request(url, data=data, method=method)
        try:
            return urllib.request.urlopen(req, timeout=pol.attempt_timeout)
        except urllib.error.HTTPError as exc:
            if exc.code in (408, 429) or exc.code >= 500:
                raise
            try:
                detail = json.loads(exc.read()).get("RemoteException", {})
                msg = detail.get("message", str(exc))
            except Exception:  # noqa: BLE001 - a body that is not JSON
                msg = str(exc)
            raise DMLCError(f"webhdfs {method} failed ({exc.code}): {msg}") from exc

    if not retry:
        return attempt()
    return pol.call(attempt, op=op, what=url)


class HdfsReadStream(HttpReadStream):
    """Range reads over ``op=OPEN`` (the pread counterpart,
    hdfs_filesys.cc:46-58)."""

    def __init__(self, cfg: HdfsConfig, path: str, size: int):
        self._cfg = cfg
        self._path = path
        super().__init__(cfg.url(path, "OPEN"), size=size)

    def _fetch(self, start: int, end: int) -> bytes:
        url = self._cfg.url(self._path, "OPEN", offset=str(start), length=str(end - start))
        with _request(url, retry=False) as resp:
            return resp.read()


class HdfsWriteStream(_pyio.RawIOBase):
    """Buffers, then the two-step create on close: ``op=CREATE`` at the
    namenode, the bytes PUT to the datanode it names."""

    def __init__(self, cfg: HdfsConfig, path: str, overwrite: bool = True):
        self._cfg = cfg
        self._path = path
        self._overwrite = "true" if overwrite else "false"
        self._buf = bytearray()
        self._closed = False

    def writable(self) -> bool:
        return True

    def write(self, b) -> int:
        self._buf += bytes(b)
        return len(b)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        url = self._cfg.url(self._path, "CREATE", overwrite=self._overwrite, noredirect="true")
        with _request(url, method="PUT", op="write") as resp:
            body = resp.read()
            location = resp.headers.get("Location")
        if not location and body:
            try:
                location = json.loads(body).get("Location")
            except ValueError:
                location = None
        check(location is not None, "webhdfs CREATE returned no datanode location")
        with _request(location, method="PUT", data=bytes(self._buf), op="write"):
            pass
        self._buf = bytearray()
        super().close()


def _info_from_status(base: URI, name: str, st: Dict) -> FileInfo:
    kind = FILE_TYPE if st.get("type") == "FILE" else DIR_TYPE
    path = base if not name else URI(str(base).rstrip("/") + "/" + name)
    return FileInfo(path, int(st.get("length", 0)), kind)


class HdfsFileSystem(FileSystem):
    """WebHDFS files (the surface of src/io/hdfs_filesys.cc, without the JVM)."""

    native_resilience = True  # HdfsReadStream resumes at the failed offset

    def __init__(self, cfg: HdfsConfig):
        self.cfg = cfg

    @classmethod
    def instance(cls, uri: URI) -> "HdfsFileSystem":
        return cls(HdfsConfig(uri))

    def get_path_info(self, path: URI) -> FileInfo:
        with _request(self.cfg.url(path.name, "GETFILESTATUS"), op="open") as resp:
            st = json.loads(resp.read())["FileStatus"]
        return _info_from_status(path, "", st)

    def list_directory(self, path: URI) -> List[FileInfo]:
        with _request(self.cfg.url(path.name, "LISTSTATUS"), op="open") as resp:
            statuses = json.loads(resp.read())["FileStatuses"]["FileStatus"]
        return [_info_from_status(path, st.get("pathSuffix", ""), st) for st in statuses]

    def open(self, path: URI, mode: str):
        if mode == "r":
            return _pyio.BufferedReader(
                HdfsReadStream(self.cfg, path.name, self.get_path_info(path).size))
        if mode == "a":
            # no append without dfs.support.append, as in the reference
            raise DMLCError("webhdfs append not supported; write whole objects")
        if mode == "w":
            return _pyio.BufferedWriter(HdfsWriteStream(self.cfg, path.name))
        raise DMLCError(f"unsupported hdfs open mode {mode!r}")


register_filesystem("hdfs://", HdfsFileSystem.instance)
register_filesystem("viewfs://", HdfsFileSystem.instance)
