"""GCS filesystem: a bearer-token JSON API client over urllib.

Own copy of the JAX package's ``io/gcs_filesys.py``, with the reference's
S3 client surface (src/io/s3_filesys.cc) and GCS's auth:

- reads: ``Range: bytes=N-M`` GETs on the media endpoint, through the
  shared HTTP block reader (retried and resumed at the failed offset);
- listings: the JSON ``objects.list`` with prefix, delimiter and page
  tokens;
- writes: one media upload on close;
- auth: ``GCS_OAUTH_TOKEN`` / ``GOOGLE_OAUTH_ACCESS_TOKEN``, else the GCE
  metadata server's token (cached until a minute before it expires; a
  miss is cached for five minutes, so a machine without the server pays
  one probe's timeout every five minutes), else anonymous (public
  buckets). Set a token in the environment to keep the probe off the
  network.

``GCS_ENDPOINT`` overrides the API's base URL (default
``https://storage.googleapis.com``).
"""

from __future__ import annotations

import io as _pyio
import json
import os
import urllib.error
import urllib.parse
import urllib.request
from typing import Dict, List, Optional, Tuple

from dmlc_tpu_torch.io.filesystem import (DIR_TYPE, FILE_TYPE, FileInfo, FileSystem,
                                          register_filesystem)
from dmlc_tpu_torch.io.http_filesys import HttpReadStream
from dmlc_tpu_torch.io.resilience import default_policy
from dmlc_tpu_torch.io.uri import URI
from dmlc_tpu_torch.utils.check import DMLCError, check
from dmlc_tpu_torch.utils.timer import get_time

_METADATA_TOKEN_URL = ("http://metadata.google.internal/computeMetadata/v1/"
                       "instance/service-accounts/default/token")

_metadata_token: Optional[str] = None
_metadata_expiry = float("-inf")


def _auth_token() -> Optional[str]:
    tok = os.environ.get("GCS_OAUTH_TOKEN") or os.environ.get("GOOGLE_OAUTH_ACCESS_TOKEN")
    if tok:
        return tok
    global _metadata_token, _metadata_expiry
    now = get_time()
    if now < _metadata_expiry:
        return _metadata_token
    req = urllib.request.Request(_METADATA_TOKEN_URL, headers={"Metadata-Flavor": "Google"})
    try:
        with urllib.request.urlopen(req, timeout=1) as resp:
            payload = json.loads(resp.read())
        _metadata_token = payload.get("access_token")
        # refreshed a minute early; tokens last about an hour
        _metadata_expiry = now + max(int(payload.get("expires_in", 300)) - 60, 30)
    except (urllib.error.URLError, OSError, ValueError):
        _metadata_token = None
        _metadata_expiry = now + 300  # probe an absent server again in 5 minutes
    return _metadata_token


class GcsConfig:
    def __init__(self) -> None:
        self.endpoint = os.environ.get("GCS_ENDPOINT", "https://storage.googleapis.com")

    def headers(self) -> Dict[str, str]:
        tok = _auth_token()
        return {"Authorization": f"Bearer {tok}"} if tok else {}

    def media_url(self, bucket: str, key: str) -> str:
        return f"{self.meta_url(bucket, key)}?alt=media"

    def meta_url(self, bucket: str, key: str) -> str:
        return f"{self.endpoint}/storage/v1/b/{bucket}/o/{urllib.parse.quote(key, safe='')}"

    def list_url(self, bucket: str, query: Dict[str, str]) -> str:
        return (f"{self.endpoint}/storage/v1/b/{bucket}/o?"
                + urllib.parse.urlencode(sorted(query.items())))

    def upload_url(self, bucket: str, key: str) -> str:
        return (f"{self.endpoint}/upload/storage/v1/b/{bucket}/o?"
                + urllib.parse.urlencode({"uploadType": "media", "name": key}))


def _parse_gs_uri(uri: URI) -> Tuple[str, str]:
    return uri.host, uri.name.lstrip("/")


class GcsReadStream(HttpReadStream):
    """Range GETs with bearer auth."""

    def __init__(self, cfg: GcsConfig, bucket: str, key: str, size: int):
        self._cfg = cfg
        super().__init__(cfg.media_url(bucket, key), size=size)

    def _fetch(self, start: int, end: int) -> bytes:
        """One attempt; the token is read again each time, so a rotation
        heals mid-stream."""
        headers = {"Range": f"bytes={start}-{end - 1}"}
        headers.update(self._cfg.headers())
        req = urllib.request.Request(self.url, headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=self._policy.attempt_timeout) as resp:
                body = resp.read()
                return body if resp.status == 206 else body[start:end]
        except urllib.error.HTTPError as exc:
            if exc.code == 416:
                return b""
            raise


class GcsWriteStream(_pyio.RawIOBase):
    """Buffers, then one media upload on close (retried whole: it is
    idempotent)."""

    def __init__(self, cfg: GcsConfig, bucket: str, key: str):
        super().__init__()
        self._cfg = cfg
        self._bucket = bucket
        self._key = key
        self._buf = bytearray()
        self._done = False

    def writable(self) -> bool:
        return True

    def write(self, b) -> int:
        self._buf += bytes(b)
        return len(b)

    def close(self) -> None:
        if self._done:
            return
        self._done = True
        url = self._cfg.upload_url(self._bucket, self._key)
        policy = default_policy()

        def attempt() -> None:
            headers = {"Content-Type": "application/octet-stream"}
            headers.update(self._cfg.headers())
            req = urllib.request.Request(url, data=bytes(self._buf), method="POST",
                                         headers=headers)
            with urllib.request.urlopen(req, timeout=max(policy.attempt_timeout, 300)) as resp:
                check(resp.status in (200, 201), f"gcs upload failed: {resp.status}")

        policy.call(attempt, op="write", what=f"gs://{self._bucket}/{self._key}")
        super().close()


class GcsFileSystem(FileSystem):
    """``gs://`` over the JSON API."""

    native_resilience = True  # GcsReadStream resumes at the failed offset

    _instance: Optional["GcsFileSystem"] = None

    def __init__(self, cfg: Optional[GcsConfig] = None):
        self.cfg = cfg or GcsConfig()

    @classmethod
    def instance(cls, uri: Optional[URI] = None) -> "GcsFileSystem":
        if cls._instance is None:
            cls._instance = cls()
        else:
            cls._instance.cfg = GcsConfig()
        return cls._instance

    def _get_json(self, url: str, cfg: Optional[GcsConfig] = None) -> Tuple[int, dict]:
        policy = default_policy()

        def attempt() -> Tuple[int, dict]:
            req = urllib.request.Request(url, headers=(cfg or self.cfg).headers())
            try:
                with urllib.request.urlopen(req, timeout=policy.attempt_timeout) as resp:
                    return resp.status, json.loads(resp.read() or b"{}")
            except urllib.error.HTTPError as exc:
                if exc.code == 429 or exc.code >= 500:
                    raise  # transient: the policy retries it
                return exc.code, {}  # a deterministic status: the caller branches

        return policy.call(attempt, op="open", what=url)

    def get_path_info(self, path: URI, cfg: Optional[GcsConfig] = None) -> FileInfo:
        if cfg is None:
            cfg = self.cfg
        bucket, key = _parse_gs_uri(path)
        status, meta = self._get_json(cfg.meta_url(bucket, key), cfg=cfg)
        if status == 200:
            return FileInfo(path, int(meta.get("size", 0)), FILE_TYPE)
        prefix = key.rstrip("/") + "/" if key else ""
        if self._list(bucket, prefix, max_results=1, max_total=1, cfg=cfg):
            return FileInfo(path, 0, DIR_TYPE)
        raise DMLCError(f"gcs path not found: {str(path)}")

    def _list(self, bucket: str, prefix: str, max_results: int = 1000,
              max_total: Optional[int] = None,
              cfg: Optional[GcsConfig] = None) -> List[Tuple[str, int, str]]:
        cfg = cfg or self.cfg
        out: List[Tuple[str, int, str]] = []
        token: Optional[str] = None
        while True:
            query = {"prefix": prefix, "delimiter": "/", "maxResults": str(max_results)}
            if token:
                query["pageToken"] = token
            status, data = self._get_json(cfg.list_url(bucket, query), cfg=cfg)
            check(status == 200, f"gcs list failed: {status}")
            for item in data.get("items", []):
                out.append((item["name"], int(item.get("size", 0)), FILE_TYPE))
            for p in data.get("prefixes", []):
                out.append((p, 0, DIR_TYPE))
            token = data.get("nextPageToken")
            if not token or (max_total is not None and len(out) >= max_total):
                return out

    def list_directory(self, path: URI) -> List[FileInfo]:
        bucket, key = _parse_gs_uri(path)
        prefix = key.rstrip("/") + "/" if key else ""
        return [FileInfo(URI(f"gs://{bucket}/{k}"), size, typ)
                for k, size, typ in self._list(bucket, prefix)]

    def open(self, path: URI, mode: str):
        cfg = self.cfg
        bucket, key = _parse_gs_uri(path)
        if "r" in mode:
            info = self.get_path_info(path, cfg=cfg)
            check(info.type == FILE_TYPE, f"not a file: {str(path)}")
            return _pyio.BufferedReader(GcsReadStream(cfg, bucket, key, info.size))
        if "w" in mode:
            return _pyio.BufferedWriter(GcsWriteStream(cfg, bucket, key))
        raise DMLCError(f"unsupported gcs open mode {mode!r}")

    def open_for_read(self, path: URI):
        return self.open(path, "rb")


register_filesystem("gs://", GcsFileSystem.instance)
