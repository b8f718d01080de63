"""S3 filesystem: an AWS Signature V4 client over urllib.

Own copy of the JAX package's ``io/s3_filesys.py``, the counterpart of the
reference's src/io/s3_filesys.cc:

- SigV4 signing (SignSig4, s3_filesys.cc:319) as pure functions,
  :func:`canonical_request`, :func:`signing_key` and :func:`sign_v4`, which
  the published worked examples pin;
- Range-GET read streams on the shared HTTP block reader
  (CURLReadStreamBase, s3_filesys.cc:422-701), each block under the retry
  budget and resumed at its offset;
- ListObjectsV2 listings, page by page (XMLIter, s3_filesys.cc:27);
- multipart uploads (Init / Upload / Finish, s3_filesys.cc:768-1010) in
  parts of ``DMLC_S3_WRITE_BUFFER_MB``, and one PUT for an object smaller
  than a part;
- the environment: ``S3_ACCESS_KEY_ID`` / ``AWS_ACCESS_KEY_ID``,
  ``S3_SECRET_ACCESS_KEY`` / ``AWS_SECRET_ACCESS_KEY``, ``S3_SESSION_TOKEN``
  / ``AWS_SESSION_TOKEN``, ``S3_ENDPOINT`` (path-style addressing against a
  custom endpoint), ``S3_REGION`` / ``AWS_REGION``, ``S3_VERIFY_SSL`` and
  ``DMLC_S3_WRITE_BUFFER_MB`` (s3_filesys.cc:781, 1151-1166).
  :meth:`S3FileSystem.instance` reads it again on every lookup, so keys
  and endpoint may change after import.

Each request is signed again at every attempt, so that its ``x-amz-date``
stays current.
"""

from __future__ import annotations

import datetime as _dt
import hashlib
import hmac
import io as _pyio
import os
import urllib.error
import urllib.parse
import urllib.request
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple

from dmlc_tpu_torch.io.filesystem import (DIR_TYPE, FILE_TYPE, FileInfo, FileSystem,
                                          register_filesystem)
from dmlc_tpu_torch.io.http_filesys import HttpReadStream
from dmlc_tpu_torch.io.resilience import RetryPolicy, default_policy
from dmlc_tpu_torch.io.uri import URI
from dmlc_tpu_torch.utils.check import DMLCError, check

_EMPTY_SHA256 = hashlib.sha256(b"").hexdigest()


# ---------------- SigV4 (pure functions) ----------------

def _uri_encode(s: str, encode_slash: bool = True) -> str:
    """AWS's canonical encoding: the RFC 3986 unreserved characters stay,
    a space is ``%20`` (never ``+``), ``/`` stays unless ``encode_slash``."""
    return urllib.parse.quote(s, safe="-._~" + ("" if encode_slash else "/"))


def canonical_request(method: str, path: str, query: Dict[str, str], headers: Dict[str, str],
                      payload_sha256: str) -> Tuple[str, str]:
    """The canonical request and its signed-header list."""
    cq = "&".join(f"{_uri_encode(k)}={_uri_encode(str(v))}" for k, v in sorted(query.items()))
    lower = {k.lower().strip(): " ".join(str(v).split()) for k, v in headers.items()}
    signed_headers = ";".join(sorted(lower))
    ch = "".join(f"{k}:{lower[k]}\n" for k in sorted(lower))
    cr = "\n".join([method.upper(), _uri_encode(path, encode_slash=False) or "/", cq, ch,
                    signed_headers, payload_sha256])
    return cr, signed_headers


def signing_key(secret: str, date: str, region: str, service: str) -> bytes:
    """The HMAC chain kSecret -> kDate -> kRegion -> kService -> kSigning."""
    def h(key: bytes, msg: str) -> bytes:
        return hmac.new(key, msg.encode(), hashlib.sha256).digest()

    return h(h(h(h(b"AWS4" + secret.encode(), date), region), service), "aws4_request")


def sign_v4(method: str, host: str, path: str, query: Dict[str, str], headers: Dict[str, str],
            payload_sha256: str, access_key: str, secret_key: str, region: str,
            service: str = "s3", amz_date: Optional[str] = None,
            session_token: Optional[str] = None) -> Dict[str, str]:
    """The request's headers with ``Authorization`` and the ``x-amz-*``
    set (``host`` is signed and left out: urllib sends it)."""
    if amz_date is None:
        amz_date = _dt.datetime.now(_dt.timezone.utc).strftime("%Y%m%dT%H%M%SZ")
    date = amz_date[:8]
    hdrs = dict(headers)
    hdrs["host"] = host
    hdrs["x-amz-date"] = amz_date
    hdrs["x-amz-content-sha256"] = payload_sha256
    if session_token:
        hdrs["x-amz-security-token"] = session_token
    cr, signed_headers = canonical_request(method, path, query, hdrs, payload_sha256)
    scope = f"{date}/{region}/{service}/aws4_request"
    sts = "\n".join(["AWS4-HMAC-SHA256", amz_date, scope,
                     hashlib.sha256(cr.encode()).hexdigest()])
    sig = hmac.new(signing_key(secret_key, date, region, service), sts.encode(),
                   hashlib.sha256).hexdigest()
    hdrs["Authorization"] = (f"AWS4-HMAC-SHA256 Credential={access_key}/{scope}, "
                             f"SignedHeaders={signed_headers}, Signature={sig}")
    del hdrs["host"]
    return hdrs


# ---------------- credentials and endpoint ----------------

class S3Config:
    """Credentials and endpoint from the environment (s3_filesys.cc:1151-1166)."""

    def __init__(self) -> None:
        env = os.environ
        self.access_key = env.get("S3_ACCESS_KEY_ID") or env.get("AWS_ACCESS_KEY_ID")
        self.secret_key = env.get("S3_SECRET_ACCESS_KEY") or env.get("AWS_SECRET_ACCESS_KEY")
        self.session_token = env.get("S3_SESSION_TOKEN") or env.get("AWS_SESSION_TOKEN")
        self.region = env.get("S3_REGION") or env.get("AWS_REGION") or "us-east-1"
        self.endpoint = env.get("S3_ENDPOINT")  # e.g. http://127.0.0.1:9999
        self.verify_ssl = env.get("S3_VERIFY_SSL", "1") != "0"
        self.write_buffer_mb = int(env.get("DMLC_S3_WRITE_BUFFER_MB", "8"))

    def require_keys(self) -> None:
        check(bool(self.access_key) and bool(self.secret_key),
              "S3 credentials missing: set S3_ACCESS_KEY_ID/S3_SECRET_ACCESS_KEY (or AWS_*)")

    def url_for(self, bucket: str, key: str) -> Tuple[str, str, str]:
        """``(url, host, canonical path)`` of ``bucket/key``; the URL carries
        the %-encoding the signature covers (S3 recomputes the canonical
        request from the bytes sent)."""
        path = "/" + key.lstrip("/")
        enc_path = _uri_encode(path, encode_slash=False)
        if self.endpoint:
            host = urllib.parse.urlparse(self.endpoint).netloc
            return f"{self.endpoint.rstrip('/')}/{bucket}{enc_path}", host, f"/{bucket}{path}"
        host = f"{bucket}.s3.{self.region}.amazonaws.com"
        return f"https://{host}{enc_path}", host, path


def _parse_s3_uri(uri: URI) -> Tuple[str, str]:
    """``s3://bucket/key`` -> ``(bucket, key)``."""
    return uri.host, uri.name.lstrip("/")


def _lower_headers(headers) -> Dict[str, str]:
    # HTTP header names are case-insensitive: a proxy's content-length
    # must not read as size 0
    return {k.lower(): v for k, v in headers.items()}


def _request(cfg: S3Config, method: str, bucket: str, key: str,
             query: Optional[Dict[str, str]] = None, headers: Optional[Dict[str, str]] = None,
             body: bytes = b"", op: str = "request", policy: Optional[RetryPolicy] = None,
             retry: bool = True) -> Tuple[int, bytes, Dict[str, str]]:
    """One signed request under the retry policy: ``(status, body, headers)``
    with lower-cased header names. 404, 403 and 416 return their status for
    the caller to branch on; other HTTP errors raise for the classifier,
    and a transient one is retried, signed again. ``retry=False`` makes one
    raw attempt (the read stream's budget is its own)."""
    cfg.require_keys()
    query = dict(query or {})
    url, host, path = cfg.url_for(bucket, key)
    if query:
        # the canonical query's encoding ('%20', never '+')
        url += "?" + "&".join(f"{_uri_encode(k)}={_uri_encode(str(v))}"
                              for k, v in sorted(query.items()))
    payload_hash = hashlib.sha256(body).hexdigest() if body else _EMPTY_SHA256
    pol = policy or default_policy()

    def attempt() -> Tuple[int, bytes, Dict[str, str]]:
        hdrs = sign_v4(method, host, path, query, dict(headers or {}), payload_hash,
                       cfg.access_key, cfg.secret_key, cfg.region,
                       session_token=cfg.session_token)
        req = urllib.request.Request(url, data=body or None, method=method, headers=hdrs)
        try:
            with urllib.request.urlopen(req, timeout=pol.attempt_timeout) as resp:
                return resp.status, resp.read(), _lower_headers(resp.headers)
        except urllib.error.HTTPError as exc:
            if exc.code in (404, 403, 416):
                return exc.code, exc.read(), _lower_headers(exc.headers)
            raise

    if not retry:
        return attempt()
    return pol.call(attempt, op=op, what=f"s3://{bucket}/{key}")


# ---------------- streams ----------------

class S3ReadStream(HttpReadStream):
    """Signed Range GETs (ReadStream, s3_filesys.cc:664-745)."""

    def __init__(self, cfg: S3Config, bucket: str, key: str, size: int):
        self._cfg = cfg
        self._bucket = bucket
        self._key = key
        super().__init__(cfg.url_for(bucket, key)[0], size=size)

    def _fetch(self, start: int, end: int) -> bytes:
        status, body, _ = _request(self._cfg, "GET", self._bucket, self._key,
                                   headers={"Range": f"bytes={start}-{end - 1}"}, retry=False)
        if status == 416:
            return b""
        if status == 200:
            return body[start:end]  # the server ignored the Range header
        if status == 206:
            return body
        raise DMLCError(f"s3 read failed: {self._bucket}/{self._key}: {status}")


class S3WriteStream(_pyio.RawIOBase):
    """Multipart upload (WriteStream Init / Upload / Finish,
    s3_filesys.cc:768-1010): parts of ``DMLC_S3_WRITE_BUFFER_MB``, and one
    PUT on close for an object smaller than a part."""

    def __init__(self, cfg: S3Config, bucket: str, key: str):
        super().__init__()
        self._cfg = cfg
        self._bucket = bucket
        self._key = key
        self._buf = bytearray()
        self._part_bytes = cfg.write_buffer_mb << 20
        self._upload_id: Optional[str] = None
        self._etags: List[str] = []
        self._closed = False

    def writable(self) -> bool:
        return True

    def write(self, b) -> int:
        self._buf += bytes(b)
        while len(self._buf) >= self._part_bytes:
            self._upload_part(bytes(self._buf[: self._part_bytes]))
            del self._buf[: self._part_bytes]
        return len(b)

    def _init_multipart(self) -> None:
        status, body, _ = _request(self._cfg, "POST", self._bucket, self._key,
                                   query={"uploads": ""}, op="write")
        check(status == 200, f"s3 multipart init failed: {status}")
        root = ET.fromstring(body)
        node = root.find(".//{*}UploadId")
        if node is None:
            node = root.find(".//UploadId")
        check(node is not None and node.text, "s3 multipart init: no UploadId in response")
        self._upload_id = node.text

    def _upload_part(self, data: bytes) -> None:
        if self._upload_id is None:
            self._init_multipart()
        part_number = len(self._etags) + 1
        status, _, headers = _request(
            self._cfg, "PUT", self._bucket, self._key,
            query={"partNumber": str(part_number), "uploadId": self._upload_id},
            body=data, op="write")
        check(status == 200, f"s3 part {part_number} upload failed: {status}")
        self._etags.append(headers.get("etag", ""))

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._upload_id is None:
            status, _, _ = _request(self._cfg, "PUT", self._bucket, self._key,
                                    body=bytes(self._buf), op="write")
            check(status == 200, f"s3 put failed: {status}")
        else:
            if self._buf:
                self._upload_part(bytes(self._buf))
                self._buf.clear()
            parts = "".join(f"<Part><PartNumber>{i + 1}</PartNumber><ETag>{etag}</ETag></Part>"
                            for i, etag in enumerate(self._etags))
            body = f"<CompleteMultipartUpload>{parts}</CompleteMultipartUpload>".encode()
            status, _, _ = _request(self._cfg, "POST", self._bucket, self._key,
                                    query={"uploadId": self._upload_id}, body=body, op="write")
            check(status == 200, f"s3 multipart complete failed: {status}")
        super().close()


# ---------------- filesystem ----------------

class S3FileSystem(FileSystem):
    """``s3://`` over the SigV4 client."""

    native_resilience = True  # S3ReadStream resumes at the failed offset

    _instance: Optional["S3FileSystem"] = None

    def __init__(self, cfg: Optional[S3Config] = None):
        self.cfg = cfg or S3Config()

    @classmethod
    def instance(cls, uri: Optional[URI] = None) -> "S3FileSystem":
        """The process's member, its configuration read from the
        environment again at every lookup (keys and endpoint may rotate)."""
        if cls._instance is None:
            cls._instance = cls()
        else:
            cls._instance.cfg = S3Config()
        return cls._instance

    def get_path_info(self, path: URI, cfg: Optional[S3Config] = None) -> FileInfo:
        if cfg is None:
            cfg = self.cfg  # one snapshot: instance() may swap cfg meanwhile
        bucket, key = _parse_s3_uri(path)
        status, _, headers = _request(cfg, "HEAD", bucket, key, op="open")
        if status == 200:
            return FileInfo(path, int(headers.get("content-length", 0)), FILE_TYPE)
        # a prefix listing decides a directory (the bucket root lists the
        # empty prefix, not "/")
        prefix = key.rstrip("/") + "/" if key else ""
        if self._list(bucket, prefix, max_keys=1, max_total=1, cfg=cfg):
            return FileInfo(path, 0, DIR_TYPE)
        raise DMLCError(f"s3 path not found: {str(path)}")

    def _list(self, bucket: str, prefix: str, max_keys: int = 1000,
              max_total: Optional[int] = None,
              cfg: Optional[S3Config] = None) -> List[Tuple[str, int, str]]:
        """``(key, size, type)`` under ``prefix`` by ListObjectsV2, every page."""
        cfg = cfg or self.cfg
        out: List[Tuple[str, int, str]] = []
        token: Optional[str] = None
        while True:
            query = {"list-type": "2", "prefix": prefix, "delimiter": "/",
                     "max-keys": str(max_keys)}
            if token:
                query["continuation-token"] = token
            status, body, _ = _request(cfg, "GET", bucket, "", query=query, op="open")
            check(status == 200, f"s3 list failed: {status}")
            root = ET.fromstring(body)

            def _find_all(tag: str):
                return root.findall(f".//{{*}}{tag}") or root.findall(f".//{tag}")

            def _find(node, tag: str):
                # namespaced first, then bare (a server may leave out the namespace)
                found = node.find(f"{{*}}{tag}")
                return found if found is not None else node.find(tag)

            for node in _find_all("Contents"):
                key_node, size_node = _find(node, "Key"), _find(node, "Size")
                if key_node is None or not key_node.text:
                    continue
                out.append((key_node.text, int(size_node.text) if size_node is not None else 0,
                            FILE_TYPE))
            for node in _find_all("CommonPrefixes"):
                p = _find(node, "Prefix")
                if p is not None and p.text:
                    out.append((p.text, 0, DIR_TYPE))
            nxt = root.find(".//{*}NextContinuationToken")
            if nxt is None:
                nxt = root.find(".//NextContinuationToken")
            if nxt is None or not nxt.text or (max_total is not None and len(out) >= max_total):
                return out
            token = nxt.text

    def list_directory(self, path: URI) -> List[FileInfo]:
        bucket, key = _parse_s3_uri(path)
        prefix = key.rstrip("/") + "/" if key else ""
        return [FileInfo(URI(f"s3://{bucket}/{k}"), size, typ)
                for k, size, typ in self._list(bucket, prefix)]

    def open(self, path: URI, mode: str):
        cfg = self.cfg  # one snapshot for the stat and the stream
        bucket, key = _parse_s3_uri(path)
        if "r" in mode:
            info = self.get_path_info(path, cfg=cfg)
            check(info.type == FILE_TYPE, f"not a file: {str(path)}")
            return _pyio.BufferedReader(S3ReadStream(cfg, bucket, key, info.size))
        if "w" in mode:
            return _pyio.BufferedWriter(S3WriteStream(cfg, bucket, key))
        raise DMLCError(f"unsupported s3 open mode {mode!r}")

    def open_for_read(self, path: URI):
        return self.open(path, "rb")


register_filesystem("s3://", S3FileSystem.instance)
