"""Local fakes of the cloud stores the filesystem members speak to.

One :class:`FakeCloud` serves five protocols from its own memory, each on
an ``http.server`` of its own on ``127.0.0.1``:

- ``s3``: path-style S3 (HEAD, Range GET, ListObjectsV2 with delimiter and
  pages, PUT, multipart upload), every request's AWS Signature V4 checked
  against the configured secret (a mismatch answers 403);
- ``gcs``: the JSON API (object metadata, ``alt=media`` Range reads,
  ``objects.list`` with delimiter and pages, media uploads), the bearer
  token checked (401 otherwise);
- ``hdfs``: WebHDFS (``GETFILESTATUS``, ``LISTSTATUS``, ``OPEN`` answered
  by a 307 to a datanode path, the two-step ``CREATE``);
- ``azure``: the Blob service (HEAD, Range GET, List Blobs with pages,
  Put Blob, Put Block, Put Block List), every Shared Key signature checked
  (403 otherwise);
- ``http``: plain files over HEAD and Range GET.

A protocol can answer Range GETs with 200 and the whole body
(``ignore_range``), send its header names in lower case
(``lower_headers``), and page List Blobs (``azure_page``); SAS requests
are checked against ``azure_sas_sig`` and counted (``azure.sas``).

Faults are served, not injected: :meth:`FakeCloud.add_fault` makes the
n-th matching request answer 503, 429 with a ``Retry-After``, 403, or
reset its connection after half the body. :meth:`FakeCloud.env` gives the
environment that points each filesystem member here.

The module imports nothing outside the standard library. In a test it
runs in process (``with FakeCloud() as fake: ...``); beside a program that
must not share its interpreter lock, it runs as a child process::

    python dmlc_tpu_torch/testing/fake_cloud.py

which prints one JSON line (``{"env": {...}, "control": url}``) and serves
until it is killed. The control server takes ``PUT /put?proto=&key=``
(a body into a store), ``POST /faults`` (a JSON list of
:meth:`add_fault` keywords), ``POST /clear_faults`` and ``GET /stats``
(request counts, fired faults, auth failures, uploads, and each server's
connections accepted and served).

Every server listens with a backlog of :data:`BACKLOG` (``--backlog`` as a
child process, ``FakeCloud(backlog=)``): the standard library's servers
keep ``socketserver``'s 5, and a burst of connections beyond it (the
multipart upload's, the feeder's Range GETs) overflows the accept queue,
which a client may then wait out to its whole attempt timeout.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import http.server
import json
import re
import socket
import struct
import sys
import threading
import urllib.parse
from typing import Dict, List, Optional

PROTOCOLS = ("s3", "gcs", "hdfs", "azure", "http")
ACTIONS = ("503", "429", "403", "reset")

S3_ACCESS_KEY = "fake-access-key"
S3_SECRET_KEY = "fake-secret-key"
GCS_TOKEN = "fake-gcs-token"
AZURE_ACCOUNT = "fakeaccount"
AZURE_KEY = base64.b64encode(b"fake-azure-shared-key").decode()
HDFS_USER = "fake-hdfs-user"
BACKLOG = 256  # each server's listen backlog, as the rabit tracker's


class _Fault:
    def __init__(self, proto: str, action: str, at: int = 1, method: str = "GET",
                 ranged: Optional[bool] = True, retry_after: Optional[str] = None):
        if proto not in PROTOCOLS or action not in ACTIONS:
            raise ValueError(f"fault {proto!r} {action!r}")
        self.proto, self.action, self.at = proto, action, int(at)
        self.method, self.ranged, self.retry_after = method, ranged, retry_after
        self.seen = 0
        self.fired = 0

    def matches(self, proto: str, method: str, ranged: bool) -> bool:
        return (proto == self.proto and method == self.method
                and (self.ranged is None or self.ranged == ranged))

    def as_dict(self) -> dict:
        return {"proto": self.proto, "action": self.action, "at": self.at,
                "method": self.method, "ranged": self.ranged, "seen": self.seen,
                "fired": self.fired}


def _range(header: Optional[str], size: int):
    """``(lo, hi)`` inclusive of a ``bytes=lo-hi`` header, or None."""
    if not header:
        return None
    lo, hi = header.split("=", 1)[1].split("-", 1)
    return int(lo), (int(hi) if hi else size - 1)


# ---------------- the signature checks (from the published algorithms) ----------------

def _s3_expected(method: str, raw_path: str, query: List, headers, secret: str) -> Optional[str]:
    """The SigV4 Authorization a request with these parts should carry,
    recomputed on the server side, or None if it carries none."""
    auth = headers.get("Authorization", "")
    if not auth.startswith("AWS4-HMAC-SHA256 "):
        return None
    fields = dict(p.strip().split("=", 1) for p in auth[len("AWS4-HMAC-SHA256 "):].split(","))
    access, date, region, service, _ = fields["Credential"].split("/")
    signed = fields["SignedHeaders"].split(";")
    enc = lambda s: urllib.parse.quote(s, safe="-._~")  # noqa: E731
    canon_uri = urllib.parse.quote(urllib.parse.unquote(raw_path), safe="-._~/") or "/"
    canon_query = "&".join(f"{enc(k)}={enc(v)}" for k, v in sorted(query))
    canon_headers = "".join(f"{h}:{' '.join(str(headers.get(h, '')).split())}\n"
                            for h in signed)
    amz_date = headers.get("x-amz-date", "")
    cr = "\n".join([method, canon_uri, canon_query, canon_headers, ";".join(signed),
                    headers.get("x-amz-content-sha256", "")])
    scope = f"{date}/{region}/{service}/aws4_request"
    sts = "\n".join(["AWS4-HMAC-SHA256", amz_date, scope, hashlib.sha256(cr.encode()).hexdigest()])
    key = ("AWS4" + secret).encode()
    for part in (date, region, service, "aws4_request"):
        key = hmac.new(key, part.encode(), hashlib.sha256).digest()
    sig = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
    return (f"AWS4-HMAC-SHA256 Credential={access}/{scope}, "
            f"SignedHeaders={';'.join(signed)}, Signature={sig}")


def _azure_expected(method: str, raw_path: str, query: Dict[str, str], headers,
                    account: str, key: str) -> str:
    """The Shared Key Authorization, from the Blob service's auth spec."""
    low = {k.lower(): v for k, v in headers.items()}
    cl = low.get("content-length", "")
    canon_headers = "".join(f"{k}:{low[k]}\n" for k in sorted(low) if k.startswith("x-ms-"))
    resource = f"/{account}{raw_path}"
    for k in sorted(query, key=str.lower):
        resource += f"\n{k.lower()}:{query[k]}"
    sts = "\n".join([
        method, low.get("content-encoding", ""), low.get("content-language", ""),
        "" if cl == "0" else cl, low.get("content-md5", ""), low.get("content-type", ""),
        "", low.get("if-modified-since", ""), low.get("if-match", ""),
        low.get("if-none-match", ""), low.get("if-unmodified-since", ""),
        low.get("range", ""),
    ]) + "\n" + canon_headers + resource
    mac = hmac.new(base64.b64decode(key), sts.encode(), hashlib.sha256)
    return f"SharedKey {account}:" + base64.b64encode(mac.digest()).decode()


# ---------------- the handlers ----------------

class _Handler(http.server.BaseHTTPRequestHandler):
    cloud: "FakeCloud" = None
    proto: str = ""

    def log_message(self, *a):
        pass

    # -- plumbing --
    def _body(self) -> bytes:
        n = int(self.headers.get("Content-Length", 0) or 0)
        return self.rfile.read(n) if n else b""

    def _reply(self, code: int, body: bytes = b"", headers: Optional[Dict[str, str]] = None):
        self.send_response(code)
        headers = dict(headers or {})
        headers.setdefault("Content-Length", str(len(body)))
        for k, v in headers.items():
            self.send_header(k.lower() if self.proto in self.cloud.lower_headers else k, v)
        self.end_headers()
        if self.command != "HEAD" and body:
            self.wfile.write(body)

    def _serve_bytes(self, data: bytes, extra: Optional[Dict[str, str]] = None,
                     fault: Optional[_Fault] = None) -> None:
        """A (ranged) GET's answer: 206 with the range, 416 past the end,
        200 with everything when the server ignores ranges; a ``reset``
        fault sends half the body and resets the connection."""
        rng = None if self.cloud.ignore_range.get(self.proto) else _range(
            self.headers.get("Range"), len(data))
        if rng is not None and rng[0] >= len(data):
            self._reply(416)
            return
        code, chunk = (206, data[rng[0]:rng[1] + 1]) if rng else (200, data)
        if fault is not None and fault.action == "reset":
            self.send_response(code)
            self.send_header("Content-Length", str(len(chunk)))
            self.end_headers()
            self.wfile.write(chunk[: len(chunk) // 2])
            self.wfile.flush()
            # SO_LINGER 0: close with a reset, mid-body
            self.connection.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                                       struct.pack("ii", 1, 0))
            self.connection.close()
            self.close_connection = True
            return
        self._reply(code, chunk, extra)
        self.cloud._count(self.proto, "bytes_sent", len(chunk))

    def _fault(self, ranged: bool) -> Optional[_Fault]:
        """The fault this request fires, answered here unless it is a
        reset (which :meth:`_serve_bytes` serves)."""
        fault = self.cloud._take_fault(self.proto, self.command, ranged)
        if fault is None or fault.action == "reset":
            return fault
        if fault.action == "429":
            self._reply(429, b"", {"Retry-After": fault.retry_after or "0"})
        else:
            self._reply(int(fault.action), b"")
        return fault

    def _dispatch(self):
        self.cloud._count(self.proto, self.command)
        parsed = urllib.parse.urlparse(self.path)
        query = urllib.parse.parse_qsl(parsed.query, keep_blank_values=True)
        # a read of bytes: a Range GET, or a WebHDFS datanode's OPEN
        ranged = "Range" in self.headers or (self.proto == "hdfs" and self.command == "GET"
                                             and parsed.path.startswith("/datanode"))
        body = self._body() if self.command in ("PUT", "POST") else b""
        fault = self._fault(ranged)
        if fault is not None and fault.action != "reset":
            return
        getattr(self, f"_{self.proto}")(parsed, query, body, fault)

    do_GET = do_HEAD = do_PUT = do_POST = _dispatch

    # -- s3 --
    def _s3(self, parsed, query, body, fault):
        c = self.cloud
        want = _s3_expected(self.command, parsed.path, query, self.headers, c.s3_secret)
        if want is None or self.headers.get("Authorization") != want or (
                body and hashlib.sha256(body).hexdigest()
                != self.headers.get("x-amz-content-sha256")):
            c._auth_failure(self.proto, self.command, self.path)
            self._reply(403, b"<Error><Code>SignatureDoesNotMatch</Code></Error>")
            return
        segs = urllib.parse.unquote(parsed.path).lstrip("/").split("/", 1)
        bucket, key = segs[0], (segs[1] if len(segs) > 1 else "")
        q = dict(query)
        store = c.stores["s3"]
        if self.command == "GET" and q.get("list-type") == "2":
            self._s3_list(bucket, q)
            return
        if self.command in ("GET", "HEAD"):
            data = store.get((bucket, key))
            if data is None:
                self._reply(404)
            elif self.command == "HEAD":
                self._reply(200, headers={"Content-Length": str(len(data))})
            else:
                self._serve_bytes(data, fault=fault)
            return
        if self.command == "POST" and "uploads" in q:
            with c.lock:
                upload_id = f"upl-{len(c.uploads)}"
                c.uploads[upload_id] = {"key": (bucket, key), "parts": {}, "done": False}
            self._reply(200, (f"<InitiateMultipartUploadResult><UploadId>{upload_id}"
                              f"</UploadId></InitiateMultipartUploadResult>").encode())
            return
        if self.command == "POST" and "uploadId" in q:
            up = c.uploads[q["uploadId"]]
            numbers = [int(n) for n in re.findall(
                r"<PartNumber>(\d+)</PartNumber>", body.decode())]
            with c.lock:
                store[(bucket, key)] = b"".join(up["parts"][n] for n in numbers)
                up["done"] = True
            self._reply(200)
            return
        if self.command == "PUT" and "partNumber" in q:
            with c.lock:
                c.uploads[q["uploadId"]]["parts"][int(q["partNumber"])] = body
            self._reply(200, headers={"ETag": f'"etag-{q["partNumber"]}"'})
            return
        if self.command == "PUT":
            with c.lock:
                store[(bucket, key)] = body
            self._reply(200)
            return
        self._reply(400)

    def _s3_list(self, bucket: str, q: dict):
        prefix, delim = q.get("prefix", ""), q.get("delimiter", "")
        entries = {}
        for (b, k), v in sorted(self.cloud.stores["s3"].items()):
            if b != bucket or not k.startswith(prefix):
                continue
            rest = k[len(prefix):]
            if delim and delim in rest:
                sub = prefix + rest.split(delim, 1)[0] + delim
                entries.setdefault(sub, None)
            else:
                entries[k] = len(v)
        names = sorted(entries)
        token = q.get("continuation-token")
        if token:
            names = [n for n in names if n > token]
        page = int(q.get("max-keys", "1000"))
        more = len(names) > page
        names = names[:page]
        body = ["<ListBucketResult xmlns=\"http://s3.amazonaws.com/doc/2006-03-01/\">"]
        for n in names:
            if entries[n] is None:
                body.append(f"<CommonPrefixes><Prefix>{n}</Prefix></CommonPrefixes>")
            else:
                body.append(f"<Contents><Key>{n}</Key><Size>{entries[n]}</Size></Contents>")
        if more:
            body.append(f"<IsTruncated>true</IsTruncated>"
                        f"<NextContinuationToken>{names[-1]}</NextContinuationToken>")
        body.append("</ListBucketResult>")
        self._reply(200, "".join(body).encode())

    # -- gcs --
    def _gcs(self, parsed, query, body, fault):
        c = self.cloud
        if self.headers.get("Authorization") != f"Bearer {c.gcs_token}":
            c._auth_failure(self.proto, self.command, self.path)
            self._reply(401)
            return
        q = dict(query)
        segs = parsed.path.split("/")
        store = c.stores["gcs"]
        if self.command == "POST" and parsed.path.startswith("/upload/storage/v1/b/"):
            with c.lock:
                store[(segs[5], q["name"])] = body
            self._reply(200, b"{}")
            return
        # /storage/v1/b/<bucket>/o[/<key>]
        bucket = segs[4]
        if len(segs) > 6:
            key = urllib.parse.unquote(segs[6])
            data = store.get((bucket, key))
            if data is None:
                self._reply(404)
            elif q.get("alt") == "media":
                self._serve_bytes(data, fault=fault)
            else:
                self._reply(200, json.dumps({"name": key, "size": str(len(data))}).encode())
            return
        prefix, delim = q.get("prefix", ""), q.get("delimiter", "")
        items, prefixes = [], set()
        for (b, k), v in sorted(store.items()):
            if b != bucket or not k.startswith(prefix):
                continue
            rest = k[len(prefix):]
            if delim and delim in rest:
                prefixes.add(prefix + rest.split(delim, 1)[0] + delim)
            else:
                items.append({"name": k, "size": str(len(v))})
        start = int(q.get("pageToken", "0") or 0)
        page = int(q.get("maxResults", "1000"))
        out = {"items": items[start:start + page]}
        if start + page < len(items):
            out["nextPageToken"] = str(start + page)
        else:
            out["prefixes"] = sorted(prefixes)
        self._reply(200, json.dumps(out).encode())

    # -- hdfs --
    def _json(self, code: int, obj, headers=None):
        self._reply(code, json.dumps(obj).encode(),
                    {"Content-Type": "application/json", **(headers or {})})

    def _hdfs(self, parsed, query, body, fault):
        c = self.cloud
        q = dict(query)
        store = c.stores["hdfs"]
        if "user.name" in q:
            with c.lock:
                c.hdfs_users.add(q["user.name"])
        host = self.headers.get("Host")
        if parsed.path.startswith("/datanode"):
            path = urllib.parse.unquote(parsed.path[len("/datanode"):])
            if self.command == "PUT":
                with c.lock:
                    store[path] = body
                self._reply(201)
                return
            data = store.get(path, b"")
            off = int(q.get("offset", 0))
            end = min(len(data), off + int(q.get("length", len(data) - off)))
            if fault is not None:  # a reset mid-body
                self.headers["Range"] = f"bytes={off}-{end - 1}"
                self._serve_bytes(data, fault=fault)
                return
            self._reply(200, data[off:end])
            c._count(self.proto, "bytes_sent", end - off)
            return
        path = urllib.parse.unquote(parsed.path[len("/webhdfs/v1"):])
        op = q.get("op")
        if op == "OPEN":
            if path not in store:
                self._json(404, {"RemoteException": {"message": f"File does not exist: {path}"}})
                return
            self._reply(307, headers={"Location": f"http://{host}/datanode"
                                                  f"{urllib.parse.quote(path)}?{parsed.query}"})
            return
        if op == "GETFILESTATUS":
            if path in store:
                self._json(200, {"FileStatus": {"type": "FILE", "length": len(store[path])}})
            elif any(k.startswith(path.rstrip("/") + "/") for k in store):
                self._json(200, {"FileStatus": {"type": "DIRECTORY", "length": 0}})
            else:
                self._json(404, {"RemoteException": {"message": f"File does not exist: {path}"}})
            return
        if op == "LISTSTATUS":
            prefix = path.rstrip("/") + "/"
            names = sorted({k[len(prefix):].split("/", 1)[0] for k in store
                            if k.startswith(prefix)})
            statuses = [{"pathSuffix": n, "type": "FILE", "length": len(store[prefix + n])}
                        if prefix + n in store else
                        {"pathSuffix": n, "type": "DIRECTORY", "length": 0} for n in names]
            self._json(200, {"FileStatuses": {"FileStatus": statuses}})
            return
        if op == "CREATE" and self.command == "PUT":
            loc = f"http://{host}/datanode{urllib.parse.quote(path)}?op=CREATE"
            self._json(200, {"Location": loc}, {"Location": loc})
            return
        self._json(400, {"RemoteException": {"message": f"bad op {op}"}})

    # -- azure --
    def _azure(self, parsed, query, body, fault):
        c = self.cloud
        q = dict(query)
        if "sig" in q:
            ok = q.get("sig") == c.azure_sas_sig and q.get("sv") == "2021-08-06"
            c._count(self.proto, "sas")
        else:
            ok = self.headers.get("Authorization") == _azure_expected(
                self.command, parsed.path, q, self.headers, c.azure_account, c.azure_key)
        if not ok:
            c._auth_failure(self.proto, self.command, self.path)
            self._reply(403, b"<Error><Code>AuthenticationFailed</Code></Error>")
            return
        parts = urllib.parse.unquote(parsed.path).lstrip("/").split("/", 1)
        container, name = parts[0], (parts[1] if len(parts) > 1 else "")
        store = c.stores["azure"]
        if self.command == "GET" and q.get("comp") == "list":
            self._azure_list(container, q)
            return
        if self.command in ("GET", "HEAD"):
            data = store.get((container, name))
            if data is None:
                self._reply(404)
            elif self.command == "HEAD":
                self._reply(200, headers={"Content-Length": str(len(data))})
            else:
                self._serve_bytes(data, fault=fault)
            return
        if q.get("comp") == "block":
            with c.lock:
                c.staged.setdefault((container, name), {})[q["blockid"]] = body
            self._reply(201)
            return
        if q.get("comp") == "blocklist":
            ids = re.findall(r"<Latest>([^<]+)</Latest>", body.decode())
            with c.lock:
                blocks = c.staged.pop((container, name), {})
                store[(container, name)] = b"".join(blocks[b] for b in ids)
                c.block_lists.append(len(ids))
            self._reply(201)
            return
        if self.headers.get("x-ms-blob-type") != "BlockBlob":
            self._reply(400)
            return
        with c.lock:
            store[(container, name)] = body
        self._reply(201)

    def _azure_list(self, container: str, q: dict):
        prefix, delim, marker = q.get("prefix", ""), q.get("delimiter"), q.get("marker", "")
        entries, prefixes = [], set()
        for (cn, n), data in sorted(self.cloud.stores["azure"].items()):
            if cn != container or not n.startswith(prefix) or (marker and n <= marker):
                continue
            rest = n[len(prefix):]
            if delim and delim in rest:
                prefixes.add(prefix + rest.split(delim, 1)[0] + delim)
            else:
                entries.append((n, len(data)))
        page, next_marker = self.cloud.azure_page, ""
        if page and len(entries) > page:
            next_marker = entries[page - 1][0]
            entries, prefixes = entries[:page], set()  # prefixes on the last page
        xml = ("<?xml version='1.0'?><EnumerationResults><Blobs>"
               + "".join(f"<Blob><Name>{n}</Name><Properties><Content-Length>{size}"
                         f"</Content-Length></Properties></Blob>" for n, size in entries)
               + "".join(f"<BlobPrefix><Name>{p}</Name></BlobPrefix>" for p in sorted(prefixes))
               + f"</Blobs><NextMarker>{next_marker}</NextMarker></EnumerationResults>")
        self._reply(200, xml.encode())

    # -- plain http --
    def _http(self, parsed, query, body, fault):
        data = self.cloud.stores["http"].get(urllib.parse.unquote(parsed.path))
        if data is None or self.command not in ("GET", "HEAD"):
            self._reply(404 if data is None else 405)
        elif self.command == "HEAD":
            self._reply(200, headers={"Content-Length": str(len(data))})
        else:
            self._serve_bytes(data, fault=fault)


class _Control(http.server.BaseHTTPRequestHandler):
    """The child process's control server (the module docstring)."""
    cloud: "FakeCloud" = None

    def log_message(self, *a):
        pass

    def _ok(self, obj=None):
        body = json.dumps(obj if obj is not None else {}).encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        self._ok(self.cloud.stats())

    def do_PUT(self):
        q = dict(urllib.parse.parse_qsl(urllib.parse.urlparse(self.path).query))
        body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
        self.cloud.put(q["proto"], q["key"], body)
        self._ok()

    def do_POST(self):
        path = urllib.parse.urlparse(self.path).path
        body = self.rfile.read(int(self.headers.get("Content-Length", 0) or 0))
        if path == "/faults":
            for rule in json.loads(body):
                self.cloud.add_fault(**rule)
        elif path == "/clear_faults":
            self.cloud.clear_faults()
        self._ok()


class _Server(http.server.ThreadingHTTPServer):
    """A threading HTTP server on a listen backlog of ``backlog``, counting
    the connections it accepted and those it finished serving."""

    daemon_threads = True

    def __init__(self, address, handler, backlog: int = BACKLOG):
        self.request_queue_size = int(backlog)  # read by server_activate's listen()
        self.accepted = self.served = 0
        self._count_lock = threading.Lock()
        super().__init__(address, handler)

    def get_request(self):
        request = super().get_request()
        with self._count_lock:
            self.accepted += 1
        return request

    def process_request_thread(self, request, client_address):
        try:
            super().process_request_thread(request, client_address)
        finally:
            with self._count_lock:
                self.served += 1

    def connections(self) -> Dict[str, int]:
        with self._count_lock:
            return {"accepted": self.accepted, "served": self.served,
                    "backlog": self.request_queue_size}


class FakeCloud:
    """The five fakes, their stores and their faults (the module docstring)."""

    def __init__(self, backlog: int = BACKLOG):
        self.backlog = int(backlog)
        self.s3_secret, self.gcs_token = S3_SECRET_KEY, GCS_TOKEN
        self.azure_account, self.azure_key = AZURE_ACCOUNT, AZURE_KEY
        self.azure_sas_sig = "fake-sas-signature"
        self.azure_page = 0  # >0: List Blobs pages of this many blobs
        self.lock = threading.Lock()
        self.stores: Dict[str, dict] = {p: {} for p in PROTOCOLS}
        self.uploads: Dict[str, dict] = {}   # s3 multipart uploads
        self.staged: Dict[tuple, dict] = {}  # azure blocks not yet committed
        self.block_lists: List[int] = []     # azure: blocks a committed list
        self.hdfs_users: set = set()
        self.ignore_range: Dict[str, bool] = {}  # proto: answer Range GETs 200, whole
        self.lower_headers: set = set()  # protos whose response header names are lower case
        self.faults: List[_Fault] = []
        self.requests: Dict[str, int] = {}
        self.auth_failures: List[tuple] = []
        self.ports: Dict[str, int] = {}
        self._servers: Dict[str, _Server] = {}

    # -- lifecycle --
    def _serve(self, name: str, handler) -> int:
        server = _Server(("127.0.0.1", 0), handler, self.backlog)
        threading.Thread(target=server.serve_forever, kwargs={"poll_interval": 0.05},
                         daemon=True).start()
        self._servers[name] = server
        return server.server_address[1]

    def start(self) -> "FakeCloud":
        for proto in PROTOCOLS:
            self.ports[proto] = self._serve(proto, type(f"_{proto}", (_Handler,),
                                                        {"cloud": self, "proto": proto}))
        return self

    def stop(self) -> None:
        for server in self._servers.values():
            server.shutdown()
            server.server_close()
        self._servers.clear()

    def __enter__(self) -> "FakeCloud":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def url(self, proto: str) -> str:
        return f"http://127.0.0.1:{self.ports[proto]}"

    def env(self) -> Dict[str, str]:
        """The environment that points every filesystem member here."""
        return {"S3_ENDPOINT": self.url("s3"), "S3_ACCESS_KEY_ID": S3_ACCESS_KEY,
                "S3_SECRET_ACCESS_KEY": self.s3_secret, "S3_REGION": "us-east-1",
                "GCS_ENDPOINT": self.url("gcs"), "GCS_OAUTH_TOKEN": self.gcs_token,
                "HDFS_WEBHDFS_ENDPOINT": self.url("hdfs"), "HADOOP_USER_NAME": HDFS_USER,
                "AZURE_ENDPOINT": self.url("azure"), "AZURE_STORAGE_ACCOUNT": self.azure_account,
                "AZURE_STORAGE_ACCESS_KEY": self.azure_key}

    # -- stores --
    @staticmethod
    def _key(proto: str, key: str):
        """A store key from a path: ``bucket/key`` for s3, gcs and azure,
        ``/path`` for hdfs and http."""
        if proto in ("hdfs", "http"):
            return "/" + key.lstrip("/")
        bucket, _, name = key.lstrip("/").partition("/")
        return bucket, name

    def put(self, proto: str, key: str, data: bytes) -> None:
        with self.lock:
            self.stores[proto][self._key(proto, key)] = bytes(data)

    def get(self, proto: str, key: str) -> Optional[bytes]:
        return self.stores[proto].get(self._key(proto, key))

    # -- faults and counts --
    def add_fault(self, proto: str, action: str, at: int = 1, method: str = "GET",
                  ranged: Optional[bool] = True, retry_after: Optional[str] = None) -> None:
        """Answer the ``at``-th ``method`` request to ``proto`` (a ranged
        one, or an unranged one, or either with ``ranged=None``) with
        ``action``: 503, 429 (with ``retry_after``), 403, or ``reset``
        (half the body, then the connection reset)."""
        with self.lock:
            self.faults.append(_Fault(proto, action, at, method, ranged, retry_after))

    def clear_faults(self) -> None:
        with self.lock:
            self.faults.clear()

    def _take_fault(self, proto: str, method: str, ranged: bool) -> Optional[_Fault]:
        with self.lock:
            live = [f for f in self.faults if not f.fired and f.matches(proto, method, ranged)]
            for fault in live:
                fault.seen += 1
            # two faults due at one request: the later fires at the next one
            due = [f for f in live if f.seen >= f.at]
            if due:
                due[0].fired += 1
                return due[0]
        return None

    def _count(self, proto: str, what: str, n: int = 1) -> None:
        with self.lock:
            key = f"{proto}.{what}"
            self.requests[key] = self.requests.get(key, 0) + n

    def _auth_failure(self, proto: str, method: str, path: str) -> None:
        with self.lock:
            self.auth_failures.append((proto, method, path))

    def stats(self) -> dict:
        with self.lock:
            return {"requests": dict(self.requests), "faults": [f.as_dict() for f in self.faults],
                    "auth_failures": [list(a) for a in self.auth_failures],
                    "uploads": {k: {"parts": sorted((n, len(b)) for n, b in v["parts"].items()),
                                    "done": v["done"]} for k, v in self.uploads.items()},
                    "block_lists": list(self.block_lists),
                    "connections": self.connections()}

    def connections(self) -> Dict[str, Dict[str, int]]:
        """Each server's connections accepted and served, and its backlog."""
        return {name: server.connections() for name, server in self._servers.items()}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Serve the fake cloud stores on 127.0.0.1.")
    ap.add_argument("--backlog", type=int, default=BACKLOG,
                    help="each server's listen backlog")
    args = ap.parse_args(argv)
    cloud = FakeCloud(backlog=args.backlog).start()
    # the control server is counted with the others (it serves the puts)
    cloud._serve("control", type("_ctl", (_Control,), {"cloud": cloud}))
    control = cloud._servers["control"]
    print(json.dumps({"env": cloud.env(), "ports": cloud.ports,
                      "control": f"http://127.0.0.1:{control.server_address[1]}"}), flush=True)
    try:
        threading.Event().wait()
    finally:
        cloud.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
