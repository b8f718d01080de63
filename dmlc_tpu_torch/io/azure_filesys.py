"""Azure Blob Storage filesystem: a REST client with Shared Key or SAS.

Own copy of the JAX package's ``io/azure_filesys.py``. The reference's
Azure member is a stub (only ``ListDirectory`` works, through the
azure-storage-cpp SDK: azure_filesys.h:22-31, azure_filesys.cc:33-41);
this client serves the whole FileSystem surface over the Blob service's
REST API with urllib:

- a URI is ``azure://container/path``, the container the URI's host;
- ``AZURE_STORAGE_ACCOUNT`` with ``AZURE_STORAGE_ACCESS_KEY`` (Shared Key,
  azure_filesys.cc:33-38) or ``AZURE_STORAGE_SAS_TOKEN``;
- reads: ranged GETs through the shared HTTP block reader;
- metadata: Get Blob Properties (HEAD), a prefix listing deciding a
  directory; List Blobs with ``delimiter=/``, page by page (``NextMarker``);
- writes: one Put Blob for a small object, Put Block and Put Block List
  in blocks of ``AZURE_BLOCK_MB`` (32 by default) for a large one.

Response header names are compared in lower case (an emulator may send
``content-length``). ``AZURE_ENDPOINT`` overrides
``https://{account}.blob.core.windows.net``.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import io as _pyio
import os
import urllib.error
import urllib.parse
import urllib.request
import xml.etree.ElementTree as ET
from email.utils import formatdate
from typing import Dict, List, Optional, Tuple

from dmlc_tpu_torch.io.filesystem import (DIR_TYPE, FILE_TYPE, FileInfo, FileSystem,
                                          register_filesystem)
from dmlc_tpu_torch.io.http_filesys import HttpReadStream
from dmlc_tpu_torch.io.resilience import RetryPolicy, default_policy
from dmlc_tpu_torch.io.uri import URI
from dmlc_tpu_torch.utils.check import DMLCError, check

_API_VERSION = "2021-08-06"


class AzureConfig:
    def __init__(self) -> None:
        # read per instance, so the knob works after import
        self.block_bytes = int(os.environ.get("AZURE_BLOCK_MB", "32")) * (1 << 20)
        self.account = os.environ.get("AZURE_STORAGE_ACCOUNT")
        self.key = os.environ.get("AZURE_STORAGE_ACCESS_KEY")
        self.sas = os.environ.get("AZURE_STORAGE_SAS_TOKEN", "").lstrip("?")
        check(bool(self.account),
              "Need to set environment variable AZURE_STORAGE_ACCOUNT to use Azure")
        check(bool(self.key or self.sas),
              "Need AZURE_STORAGE_ACCESS_KEY (SharedKey) or AZURE_STORAGE_SAS_TOKEN to use Azure")
        endpoint = os.environ.get("AZURE_ENDPOINT")
        self.endpoint = (endpoint.rstrip("/") if endpoint
                         else f"https://{self.account}.blob.core.windows.net")


def string_to_sign(method: str, account: str, path: str, query: Dict[str, str],
                   headers: Dict[str, str]) -> str:
    """The Blob service's Shared Key StringToSign (the 2015-02-21 format).
    ``headers`` holds the ``x-ms-*`` set; the standard headers are taken
    from it whatever their case."""
    low = {k.lower(): v for k, v in headers.items()}

    def std(name: str) -> str:
        v = low.get(name, "")
        # Content-Length is empty when zero (the 2015-02-21 change)
        return "" if name == "content-length" and v in ("0", "") else v

    canon_headers = "".join(f"{k}:{low[k]}\n" for k in sorted(low) if k.startswith("x-ms-"))
    canon_resource = f"/{account}{path}"
    for k in sorted(query, key=str.lower):
        canon_resource += f"\n{k.lower()}:{query[k]}"
    return "\n".join([
        method.upper(),
        std("content-encoding"), std("content-language"),
        std("content-length"), std("content-md5"), std("content-type"),
        # x-ms-date signs the date, and the Date line is then empty
        "" if "x-ms-date" in low else std("date"),
        std("if-modified-since"), std("if-match"), std("if-none-match"),
        std("if-unmodified-since"), std("range"),
    ]) + "\n" + canon_headers + canon_resource


def sign_shared_key(cfg: AzureConfig, method: str, path: str, query: Dict[str, str],
                    headers: Dict[str, str]) -> str:
    sts = string_to_sign(method, cfg.account, path, query, headers)
    mac = hmac.new(base64.b64decode(cfg.key), sts.encode("utf-8"), hashlib.sha256)
    return f"SharedKey {cfg.account}:{base64.b64encode(mac.digest()).decode('ascii')}"


def _request(cfg: AzureConfig, method: str, path: str, query: Optional[Dict[str, str]] = None,
             headers: Optional[Dict[str, str]] = None, data: Optional[bytes] = None,
             op: str = "request", policy: Optional[RetryPolicy] = None,
             retry: bool = True) -> Tuple[int, bytes, Dict[str, str]]:
    """One authenticated request under the retry policy: ``(status, body,
    headers)`` with lower-cased header names, for ``path`` (``/container/blob``).
    A 404 returns (a directory probe needs it); another HTTP error raises
    for the classifier, its body's first bytes in the message, and a
    transient one is retried, signed again with a fresh ``x-ms-date``.
    ``retry=False`` makes one attempt (the read stream's budget is its own)."""
    query = dict(query or {})
    pol = policy or default_policy()

    def attempt() -> Tuple[int, bytes, Dict[str, str]]:
        q = dict(query)
        hdrs = {"x-ms-date": formatdate(usegmt=True), "x-ms-version": _API_VERSION}
        hdrs.update(headers or {})
        if data is not None:
            hdrs["content-length"] = str(len(data))
            # the type signed and sent as is: urllib would add a form type
            # after the signing
            hdrs.setdefault("content-type", "application/octet-stream")
        qpath = urllib.parse.quote(path)
        if cfg.key:
            # the canonical resource is the path as sent, percent-encoded
            hdrs["Authorization"] = sign_shared_key(cfg, method, qpath, q, hdrs)
        elif cfg.sas:
            q.update(urllib.parse.parse_qsl(cfg.sas))
        qs = urllib.parse.urlencode(sorted(q.items()))
        url = cfg.endpoint + qpath + (f"?{qs}" if qs else "")
        req = urllib.request.Request(url, data=data, method=method.upper())
        for k, v in hdrs.items():
            req.add_header(k, v)
        try:
            with urllib.request.urlopen(req, timeout=pol.attempt_timeout) as resp:
                return resp.status, resp.read(), {k.lower(): v for k, v in resp.headers.items()}
        except urllib.error.HTTPError as exc:
            if exc.code == 404:
                return 404, b"", {}
            try:
                body = exc.read()
            except Exception:  # noqa: BLE001 - the body is gone
                body = b""
            if body:
                # the detail (AuthenticationFailed, the server's
                # string-to-sign) is in the XML body
                exc.msg = f"{exc.msg}: {body[:200]!r}"
            raise

    if not retry:
        return attempt()
    return pol.call(attempt, op=op, what=f"azure:/{path}")


def _parse_azure_uri(path: URI) -> Tuple[str, str]:
    check(bool(path.host), "container name not specified in azure URI (azure://container/path)")
    return path.host, path.name.lstrip("/")


class AzureReadStream(HttpReadStream):
    """Range reads over signed Get Blob requests."""

    def __init__(self, cfg: AzureConfig, container: str, key: str, size: int):
        self._cfg = cfg
        self._blob_path = f"/{container}/{key}"
        super().__init__(cfg.endpoint + self._blob_path, size=size)

    def _fetch(self, start: int, end: int) -> bytes:
        status, body, _ = _request(self._cfg, "GET", self._blob_path,
                                   headers={"range": f"bytes={start}-{end - 1}"}, retry=False)
        check(status in (200, 206), f"azure range GET -> {status}")
        if status == 200:
            # the Range header was ignored: the whole blob becomes the buffer
            self._buf = body
            self._buf_start = 0
            return body[start:end]
        return body


class AzureWriteStream(_pyio.RawIOBase):
    """A block blob: one Put Blob for a small object; a larger one staged
    in ``AZURE_BLOCK_MB`` blocks (Put Block) as they fill and committed
    with Put Block List on close."""

    def __init__(self, cfg: AzureConfig, container: str, key: str):
        self._cfg = cfg
        self._path = f"/{container}/{key}"
        self._buf = bytearray()
        self._block_ids: List[str] = []
        self._closed = False

    def writable(self) -> bool:
        return True

    def write(self, b) -> int:
        self._buf += bytes(b)
        block = self._cfg.block_bytes
        while len(self._buf) >= block:
            self._stage(bytes(self._buf[:block]))
            del self._buf[:block]
        return len(b)

    def _stage(self, chunk: bytes) -> None:
        bid = base64.b64encode(f"{len(self._block_ids):08d}".encode("ascii")).decode("ascii")
        status, _, _ = _request(self._cfg, "PUT", self._path,
                                query={"comp": "block", "blockid": bid}, data=chunk, op="write")
        check(status in (200, 201), f"azure Put Block -> {status}")
        self._block_ids.append(bid)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if not self._block_ids:
            status, _, _ = _request(self._cfg, "PUT", self._path, data=bytes(self._buf),
                                    headers={"x-ms-blob-type": "BlockBlob"}, op="write")
            check(status in (200, 201), f"azure Put Blob -> {status}")
        else:
            if self._buf:
                self._stage(bytes(self._buf))
            xml = ("<?xml version='1.0' encoding='utf-8'?><BlockList>"
                   + "".join(f"<Latest>{b}</Latest>" for b in self._block_ids)
                   + "</BlockList>").encode("utf-8")
            status, _, _ = _request(self._cfg, "PUT", self._path, query={"comp": "blocklist"},
                                    data=xml, op="write")
            check(status in (200, 201), f"azure Put Block List -> {status}")
        self._buf = bytearray()
        super().close()


class AzureFileSystem(FileSystem):
    """Blob-service files (the whole surface; the reference's is a stub
    but for ListDirectory, azure_filesys.h:22-31)."""

    native_resilience = True  # AzureReadStream resumes at the failed offset

    def __init__(self, cfg: AzureConfig):
        self.cfg = cfg

    @classmethod
    def instance(cls, uri: Optional[URI] = None) -> "AzureFileSystem":
        return cls(AzureConfig())

    def _list(self, container: str, prefix: str,
              delimiter: str = "/") -> List[Tuple[str, int, str]]:
        out: List[Tuple[str, int, str]] = []
        marker = ""
        while True:
            query = {"restype": "container", "comp": "list", "prefix": prefix}
            if delimiter:
                query["delimiter"] = delimiter
            if marker:
                query["marker"] = marker
            status, body, _ = _request(self.cfg, "GET", f"/{container}", query=query, op="open")
            check(status == 200, f"azure List Blobs -> {status}")
            root = ET.fromstring(body)
            blobs = root.find("Blobs")
            if blobs is not None:
                for el in blobs:
                    name = el.findtext("Name", "")
                    if el.tag == "Blob":
                        out.append((name, int(el.findtext("Properties/Content-Length", "0")),
                                    FILE_TYPE))
                    elif el.tag == "BlobPrefix":
                        out.append((name.rstrip("/"), 0, DIR_TYPE))
            marker = root.findtext("NextMarker", "") or ""
            if not marker:
                return out

    def get_path_info(self, path: URI) -> FileInfo:
        container, key = _parse_azure_uri(path)
        status, _, headers = _request(self.cfg, "HEAD", f"/{container}/{key}", op="open")
        if status == 200:
            return FileInfo(path, int(headers.get("content-length", 0)), FILE_TYPE)
        prefix = key.rstrip("/") + "/" if key else ""
        if self._list(container, prefix):
            return FileInfo(path, 0, DIR_TYPE)
        raise DMLCError(f"azure path not found: {str(path)}")

    def list_directory(self, path: URI) -> List[FileInfo]:
        container, key = _parse_azure_uri(path)
        prefix = key.rstrip("/") + "/" if key else ""
        return [FileInfo(URI(f"azure://{container}/{name}"), size, typ)
                for name, size, typ in self._list(container, prefix)]

    def open(self, path: URI, mode: str):
        container, key = _parse_azure_uri(path)
        if "r" in mode:
            info = self.get_path_info(path)
            check(info.type == FILE_TYPE, f"not a file: {str(path)}")
            return _pyio.BufferedReader(AzureReadStream(self.cfg, container, key, info.size))
        if "w" in mode:
            return _pyio.BufferedWriter(AzureWriteStream(self.cfg, container, key))
        raise DMLCError(f"unsupported azure open mode {mode!r}")

    def open_for_read(self, path: URI):
        return self.open(path, "rb")


register_filesystem("azure://", AzureFileSystem.instance)
