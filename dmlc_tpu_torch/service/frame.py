"""Service wire format v1: length-prefixed, CRC'd RowBlock frames.

The port's copy of the JAX package's ``service/frame.py``: the same wire,
byte for byte (both goldens), so a client of one package streams from a
fleet of the other. A bfloat16 segment travels under the dtype string
``"bfloat16"`` as the port's block cache stores it, and reads back on the
host as ``uint16`` words (:mod:`dmlc_tpu_torch.io.block_cache`).

The payload of a BLOCK frame is the block-cache v1 **segment encoding**
(:func:`dmlc_tpu_torch.io.block_cache.write_segments` — canonical
:data:`~dmlc_tpu_torch.io.block_cache.SEGMENT_NAMES` order, 64-byte-aligned
array starts, raw little-endian C-order bytes), so a parse worker's wire
frame and its on-disk cache block are the same bytes modulo framing, and
the client decodes with the exact zero-copy view machinery the warm
cache reader uses (:func:`~dmlc_tpu_torch.io.block_cache.read_segments`,
:meth:`~dmlc_tpu_torch.data.row_block.RowBlock.from_segments`).

Frame layout (pinned by ``tests/data/service_frame_v1.golden``)::

    [header]  magic "DSRV" (4B) + version u8 + kind u8 + 2 zero pad bytes
              + meta_len u32 LE + payload_len u64 LE
    [meta]    utf-8 JSON (sort_keys, compact): BLOCK frames carry
              {"arrays": {name: [dtype_str, payload_offset, nbytes]},
               "num_col", "resume", "rows"}; END frames {"blocks", "part"};
              ERROR frames {"error"}
    [payload] BLOCK only: the segment encoding (offset 0 is aligned)
    [crc]     u32 LE crc32 over meta + payload

Kinds: ``BLOCK`` (one RowBlock), ``END`` (part finished — carries the
part's total block count so clients can cross-check delivery), ``ERROR``
(the worker cannot serve; the client treats it as a retryable fault and
fails over via the dispatcher). ``resume`` is the block's byte-exact
resume annotation, shipped verbatim — a client-side checkpoint is
therefore indistinguishable from one taken against local parsing.

Integrity: the trailing crc covers meta + payload; a mismatch (torn
write, flaky link) raises :class:`ServiceFrameError`, which classifies
retryable — the client re-requests the block index from the dispatcher's
current owner instead of delivering corrupt data.

Wire v2 (pinned by ``tests/data/service_frame_v2.golden``) keeps the
header/crc layout with version byte 2 and adds: ``HELLO`` stream-open
replies (negotiated codec + co-located fast-path offer), per-segment
compression (meta gains ``codec``/``raw_len`` and a ``wire`` map;
``arrays`` keeps the RAW layout so :func:`decode_frame` rebuilds the
byte-identical v1 payload), and pipelined block fetches
(docs/service.md "Wire v2"). The crc does not cover the header, so the
v2-identity encoding of a stored v1 frame is the same body bytes with
only the version byte rewritten (:func:`reframe_v2`).
"""

from __future__ import annotations

import io
import json
import struct
import zlib
from typing import Optional, Tuple

from dmlc_tpu_torch.data.parsers import annot_key  # noqa: F401  (re-export: the
# ONE annotation normalization the local cache match and the remote find
# share — the service layer imports it from here, next to the codec)
from dmlc_tpu_torch.data.row_block import RowBlock
from dmlc_tpu_torch.io.block_cache import read_segments, write_segments
from dmlc_tpu_torch.utils import telemetry as _telemetry
from dmlc_tpu_torch.utils.check import DMLCError
from dmlc_tpu_torch.utils.timer import get_time

FRAME_MAGIC = b"DSRV"
FRAME_VERSION = 1
# wire v2: same header/crc layout, version byte 2. Adds HELLO frames
# (stream-open negotiation), per-segment compression (meta carries a
# "wire" map; "arrays" keeps the RAW layout so decode rebuilds the
# byte-identical v1 payload), and pipelined fetch (docs/service.md).
FRAME_VERSION_2 = 2

KIND_BLOCK = 1
KIND_END = 2
KIND_ERROR = 3
# a device-layout snapshot batch (dmlc_tpu_torch/io/snapshot.py positional
# segment encoding): the worker ships post-convert packed batches — bf16
# halves the wire bytes vs the f32 CSR block frames (docs/service.md)
KIND_SNAPSHOT = 4
# v2 stream-open reply: negotiated codec, part block count, and (when
# worker and client are co-located) the mmap fast-path cache offer
KIND_HELLO = 5

_HEADER_FMT = "<4sBB2xIQ"  # magic, version, kind, meta_len, payload_len
HEADER_LEN = struct.calcsize(_HEADER_FMT)
_CRC_FMT = "<I"
_CRC_LEN = struct.calcsize(_CRC_FMT)

# frames above this are refused at decode: a corrupt length prefix must
# not make the client try to allocate terabytes (1 GiB >> any real block)
MAX_FRAME_BYTES = 1 << 30

# optional trace-context key on JSON request lines (docs/service.md
# Distributed tracing): control RPCs and v1/v2 stream-open / block-fetch
# requests may carry ``{"trace": {"tid", "sid"}}``. Peers that predate
# tracing ignore unknown JSON keys, and no FRAME bytes change, so the
# v1/v2 wire goldens stay byte-pinned.
TRACE_KEY = "trace"


def attach_trace(req: dict, ctx=None) -> dict:
    """Attach a trace context (default: this thread's) to a JSON request
    dict under :data:`TRACE_KEY` — only when propagation is enabled and
    a context exists, so untraced requests stay byte-identical to the
    historical wire. Returns ``req`` for chaining."""
    wire = _telemetry.trace_context_wire(ctx)
    if wire is not None:
        req[TRACE_KEY] = wire
    return req


def extract_trace(req: dict):
    """The ``(trace_id, span_id)`` context a request line carries, or
    None — malformed/absent keys never fail the request."""
    return _telemetry.trace_context_from_wire(
        req.get(TRACE_KEY) if isinstance(req, dict) else None)


# ---------------- wire v2 compression codecs ----------------
#
# Registry of per-segment codecs: name -> (compress, decompress). zlib
# ships with CPython so it is always present; zstd/lz4 register only
# when their modules exist (no hard dependency — negotiation falls back
# through the preference order, and identity is always the floor).

def _zlib_compress(buf) -> bytes:
    return zlib.compress(bytes(buf), 6)


def _zlib_decompress(buf, raw_len: int) -> bytes:
    out = zlib.decompress(bytes(buf))
    if len(out) != raw_len:
        raise ServiceFrameError(
            f"service frame: segment inflates to {len(out)}B != {raw_len}B")
    return out


WIRE_CODECS = {"zlib": (_zlib_compress, _zlib_decompress)}

try:  # optional: python-zstandard
    import zstandard as _zstd

    def _zstd_compress(buf) -> bytes:
        return _zstd.ZstdCompressor(level=3).compress(bytes(buf))

    def _zstd_decompress(buf, raw_len: int) -> bytes:
        out = _zstd.ZstdDecompressor().decompress(
            bytes(buf), max_output_size=raw_len)
        if len(out) != raw_len:
            raise ServiceFrameError(
                f"service frame: segment inflates to {len(out)}B "
                f"!= {raw_len}B")
        return out

    WIRE_CODECS["zstd"] = (_zstd_compress, _zstd_decompress)
except ImportError:  # pragma: no cover - environment-dependent
    pass

try:  # optional: python-lz4
    import lz4.frame as _lz4

    def _lz4_compress(buf) -> bytes:
        return _lz4.compress(bytes(buf))

    def _lz4_decompress(buf, raw_len: int) -> bytes:
        out = _lz4.decompress(bytes(buf))
        if len(out) != raw_len:
            raise ServiceFrameError(
                f"service frame: segment inflates to {len(out)}B "
                f"!= {raw_len}B")
        return out

    WIRE_CODECS["lz4"] = (_lz4_compress, _lz4_decompress)
except ImportError:  # pragma: no cover - environment-dependent
    pass

# negotiation preference, best ratio/speed first among what both ends
# have; identity (None) is the implicit floor when nothing intersects
WIRE_CODEC_PREFERENCE = ("zstd", "lz4", "zlib")

# break-even table per segment dtype kind, derived from measured ratios
# on libsvm corpora (docs/service.md): delta-friendly integer segments
# (offset/index/qid/field) compress 2-5x, float value/label/weight
# segments are near-incompressible noise — attempting them burns CPU to
# ship ~100% of the bytes. A compressed segment is kept only when it
# actually beats _KEEP_RATIO, so the table is an *attempt* filter, not a
# correctness gate. Decisions are static per dtype so frames stay
# deterministic (the v2 golden byte-pin depends on it); the measured
# ratios per dtype are exported live via wire_dtype_ratios().
_COMPRESS_DTYPE_KINDS = ("i", "u")  # np dtype kind chars: int / uint
_KEEP_RATIO = 0.9
_MIN_COMPRESS_BYTES = 64

# measured compression ledger per dtype: dtype_str -> [raw_bytes, wire_bytes]
_DTYPE_RATIOS: dict = {}


def wire_dtype_ratios() -> dict:
    """Measured per-dtype compression ratios (wire/raw) accumulated by
    every v2 encode in this process — the live break-even table."""
    return {dt: (wire / raw if raw else 1.0)
            for dt, (raw, wire) in sorted(_DTYPE_RATIOS.items())}


def _dtype_compressible(dtype_str: str) -> bool:
    # segment dtype strings are numpy ``.str`` form ("<i8", "<u8",
    # "<f4"); strip the byte-order prefix and test the kind char
    kind = str(dtype_str).lstrip("<>|=")[:1]
    return kind in _COMPRESS_DTYPE_KINDS


def negotiate_codec(accept) -> Optional[str]:
    """Pick the preferred codec both ends support, or None (identity)."""
    offered = {str(a) for a in (accept or ())}
    for name in WIRE_CODEC_PREFERENCE:
        if name in offered and name in WIRE_CODECS:
            return name
    return None


class ServiceFrameError(DMLCError):
    """Malformed/corrupt wire frame. Classified RETRYABLE by
    :func:`dmlc_tpu_torch.io.resilience.classify` (chained from ConnectionError)
    — the client heals by re-requesting the block from the service."""

    def __init__(self, msg: str):
        # chain a ConnectionError cause so the shared classifier walks to
        # a retryable class without a service-specific branch
        super().__init__(msg)
        self.__cause__ = ConnectionError(msg)


def _pack(kind: int, meta: dict, payload: bytes = b"",
          version: int = FRAME_VERSION) -> bytes:
    meta_raw = json.dumps(meta, sort_keys=True,
                          separators=(",", ":")).encode()
    crc = zlib.crc32(payload, zlib.crc32(meta_raw)) & 0xFFFFFFFF
    header = struct.pack(_HEADER_FMT, FRAME_MAGIC, version, kind,
                         len(meta_raw), len(payload))
    return b"".join((header, meta_raw, payload, struct.pack(_CRC_FMT, crc)))


def encode_hello_frame(meta: dict) -> bytes:
    """V2 stream-open reply: ``{"wire": 2, "codec": <name|None>,
    "blocks": <known part total|None>}`` plus an optional ``"fastpath"``
    offer (``{"path", "blocks"}``) when the peer is co-located."""
    return _pack(KIND_HELLO, meta, version=FRAME_VERSION_2)


def encode_block_frame(block: RowBlock,
                       resume: Optional[dict] = None) -> bytes:
    """One RowBlock (+ its resume annotation) as a BLOCK frame.

    The annotation is JSON-normalized exactly as the block cache stores
    it (tuples -> lists, key order fixed), so a block decoded from the
    wire carries a byte-for-byte identical ``resume_state`` to one
    delivered by local parsing through a cache.
    """
    t0 = get_time()
    encoded = getattr(block, "encoded", None)
    if encoded is not None:
        # batch-engine block: the native parse already materialized the
        # exact segment payload (offsets span-relative == payload-
        # relative) — the frame reuses those bytes with zero re-encode,
        # the same single materialization the cache tee appends
        payload = memoryview(encoded.data)
        arrays = {name: [dt, int(off), int(nb)]
                  for name, (dt, off, nb) in encoded.arrays.items()}
        rows, num_col = int(encoded.rows), int(encoded.num_col)
    else:
        buf = io.BytesIO()
        _, _, arrays = write_segments(buf, block.to_segments())
        payload = buf.getvalue()
        rows, num_col = len(block), block.num_col
    resume_json = (json.loads(json.dumps(resume))
                   if resume is not None else None)
    meta = {
        "rows": rows,
        "num_col": num_col,
        "resume": resume_json,
        "arrays": arrays,
    }
    out = _pack(KIND_BLOCK, meta, payload)
    _telemetry.record_span("service_encode", t0, get_time() - t0,
                           rows=rows)
    return out


def reframe_v2(frame) -> Tuple[bytes, memoryview]:
    """A stored v1 frame as v2-identity send buffers, zero-copy.

    The crc trails meta+payload and does not cover the header, so the v2
    identity encoding of a v1 frame is the same bytes with only the
    header's version byte rewritten: return a fresh 20-byte header plus
    a memoryview of the original body for a vectored send.
    """
    view = memoryview(frame)
    magic, _, kind, meta_len, payload_len = struct.unpack_from(
        _HEADER_FMT, view)
    header = struct.pack(_HEADER_FMT, magic, FRAME_VERSION_2, kind,
                         meta_len, payload_len)
    return header, view[HEADER_LEN:]


def encode_block_frame_v2(meta: dict, payload,
                          codec: str) -> Optional[bytes]:
    """Re-encode a decoded v1 BLOCK frame with per-segment compression.

    ``meta["arrays"]`` keeps the RAW segment layout; a ``"wire"`` map
    (name -> [wire_offset, wire_len, compressed_flag]) plus ``"codec"``
    and ``"raw_len"`` describe the on-wire payload, so decode rebuilds
    the byte-identical raw payload (alignment gaps are zeros on both
    sides). Only break-even-eligible dtypes are attempted and a
    compressed segment is kept only when it beats ``_KEEP_RATIO``;
    returns None when nothing compressed (caller ships identity).
    """
    compress = WIRE_CODECS[codec][0]
    view = memoryview(payload)
    wire: dict = {}
    chunks = []
    woff = 0
    compressed_any = False
    for name, (dt, off, nb) in sorted(meta["arrays"].items(),
                                      key=lambda kv: kv[1][1]):
        off, nb = int(off), int(nb)
        seg = view[off:off + nb]
        raw_tot, wire_tot = _DTYPE_RATIOS.setdefault(str(dt), [0, 0])
        if _dtype_compressible(dt) and nb >= _MIN_COMPRESS_BYTES:
            comp = compress(seg)
            if len(comp) < nb * _KEEP_RATIO:
                wire[name] = [woff, len(comp), 1]
                chunks.append(comp)
                woff += len(comp)
                _DTYPE_RATIOS[str(dt)] = [raw_tot + nb,
                                          wire_tot + len(comp)]
                compressed_any = True
                continue
        wire[name] = [woff, nb, 0]
        chunks.append(bytes(seg))
        woff += nb
        _DTYPE_RATIOS[str(dt)] = [raw_tot + nb, wire_tot + nb]
    if not compressed_any:
        return None
    out_meta = dict(meta)
    out_meta["codec"] = codec
    out_meta["wire"] = wire
    out_meta["raw_len"] = len(view)
    return _pack(KIND_BLOCK, out_meta, b"".join(chunks),
                 version=FRAME_VERSION_2)


def _inflate_payload(meta: dict, payload) -> memoryview:
    """Rebuild the raw v1 payload from a compressed v2 payload; the
    result is byte-identical to what the v1 wire would have carried
    (alignment gaps restore as zeros in the fresh buffer)."""
    codec = meta.get("codec")
    if codec not in WIRE_CODECS:
        raise ServiceFrameError(f"service frame: unknown codec {codec!r}")
    decompress = WIRE_CODECS[codec][1]
    arrays = meta["arrays"]
    raw = bytearray(int(meta["raw_len"]))
    view = memoryview(payload)
    for name, (woff, wlen, enc) in meta["wire"].items():
        try:
            _, off, nb = arrays[name]
        except KeyError as exc:
            raise ServiceFrameError(
                f"service frame: wire segment {name!r} not in arrays"
            ) from exc
        off, nb = int(off), int(nb)
        chunk = view[int(woff):int(woff) + int(wlen)]
        raw[off:off + nb] = (decompress(chunk, nb) if enc
                             else chunk)
    return memoryview(raw)


def encode_snapshot_frame(kind: str, arrays, rows: int,
                          resume: Optional[dict] = None) -> bytes:
    """One device-layout batch as a SNAPSHOT frame: the positional
    snapshot segment encoding (:mod:`dmlc_tpu_torch.io.snapshot`
    ``a0..aN`` names, shapes in the meta) over the same
    :func:`~dmlc_tpu_torch.io.block_cache.write_segments` machinery as BLOCK
    frames — so a worker's snapshot frame and an on-disk snapshot batch
    are the same bytes modulo framing. ``kind`` is the host-batch kind
    (``dense_packed`` / ``dense_packed_q8`` / ...)."""
    import numpy as np
    import torch

    from dmlc_tpu_torch.io.snapshot import SNAPSHOT_SEGMENT_NAMES

    t0 = get_time()
    # a torch.bfloat16 slab is stored under "bfloat16" (write_segments)
    arrs = [a.contiguous() if isinstance(a, torch.Tensor)
            else np.ascontiguousarray(a) for a in arrays]
    buf = io.BytesIO()
    _, _, arr_meta = write_segments(
        buf, {SNAPSHOT_SEGMENT_NAMES[i]: a.reshape(-1)
              for i, a in enumerate(arrs)},
        names=SNAPSHOT_SEGMENT_NAMES)
    resume_json = (json.loads(json.dumps(resume))
                   if resume is not None else None)
    meta = {
        "kind": str(kind),
        "rows": int(rows),
        "resume": resume_json,
        "arrays": arr_meta,
        "shapes": {SNAPSHOT_SEGMENT_NAMES[i]: list(a.shape)
                   for i, a in enumerate(arrs)},
    }
    out = _pack(KIND_SNAPSHOT, meta, buf.getvalue())
    _telemetry.record_span("service_encode", t0, get_time() - t0,
                           rows=int(rows))
    return out


def snapshot_from_frame(meta: dict, payload: bytes) -> tuple:
    """Rebuild ``(kind, arr0, arr1, ...)`` from a SNAPSHOT frame — the
    arrays are zero-copy views over ``payload`` reshaped to the stored
    shapes (callers pin ``payload`` as the hold)."""
    from dmlc_tpu_torch.io.snapshot import SNAPSHOT_SEGMENT_NAMES

    t0 = get_time()
    segments = read_segments(payload, meta["arrays"])
    shapes = meta.get("shapes") or {}
    out = []
    for name in SNAPSHOT_SEGMENT_NAMES:
        if name not in segments:
            break
        arr = segments[name]
        shape = shapes.get(name)
        if shape is not None and len(shape) != 1:
            arr = arr.reshape(shape)
        out.append(arr)
    _telemetry.record_span("service_decode", t0, get_time() - t0,
                           rows=int(meta.get("rows", 0)))
    return (meta["kind"], *out)


def encode_end_frame(part: int, blocks: int,
                     draining: bool = False) -> bytes:
    """End-of-part marker carrying the part's total block count.

    ``draining=True`` marks an END served by a worker mid-drain: the
    client confirms the handoff to the dispatcher (``drain_handoffs``)
    so the drain can complete before its deadline (docs/service.md
    elastic membership). The key is only present when set, so default
    END frames stay byte-identical to the v1 golden pin.
    """
    meta = {"part": int(part), "blocks": int(blocks)}
    if draining:
        meta["draining"] = True
    return _pack(KIND_END, meta)


def encode_error_frame(message: str, draining: bool = False) -> bytes:
    """ERROR frame; ``draining=True`` marks a *graceful* drain notice —
    the part was proactively re-issued and the client should relocate
    without blaming (no ``report_lost``) or spending retry budget."""
    meta = {"error": str(message)}
    if draining:
        meta["draining"] = True
    return _pack(KIND_ERROR, meta)


def decode_frame(data) -> Tuple[int, dict, bytes]:
    """Split one raw frame into ``(kind, meta, payload)``; verifies magic,
    version, and the trailing crc. Accepts ``bytes``, ``bytearray`` or a
    ``memoryview`` (the recv path hands in its preallocated buffer —
    no ``header + rest`` concat copy). A compressed v2 payload is
    inflated here, so callers always see the raw v1 segment bytes."""
    data = memoryview(data)
    if len(data) < HEADER_LEN + _CRC_LEN:
        raise ServiceFrameError(f"service frame truncated ({len(data)}B)")
    magic, version, kind, meta_len, payload_len = struct.unpack_from(
        _HEADER_FMT, data)
    if magic != FRAME_MAGIC:
        raise ServiceFrameError(f"service frame: bad magic {magic!r}")
    if version not in (FRAME_VERSION, FRAME_VERSION_2):
        raise ServiceFrameError(
            f"service frame: version {version} not in "
            f"({FRAME_VERSION}, {FRAME_VERSION_2})")
    end = HEADER_LEN + meta_len + payload_len
    if end + _CRC_LEN != len(data):
        raise ServiceFrameError("service frame: length mismatch")
    meta_raw = data[HEADER_LEN:HEADER_LEN + meta_len]
    payload = data[HEADER_LEN + meta_len:end]
    (crc,) = struct.unpack_from(_CRC_FMT, data, end)
    if zlib.crc32(payload, zlib.crc32(meta_raw)) & 0xFFFFFFFF != crc:
        raise ServiceFrameError("service frame: crc mismatch")
    try:
        meta = json.loads(bytes(meta_raw))
    except ValueError as exc:
        raise ServiceFrameError(f"service frame: bad meta: {exc}") from exc
    if version == FRAME_VERSION_2 and isinstance(meta, dict) \
            and isinstance(meta.get("wire"), dict):
        payload = _inflate_payload(meta, payload)
    return kind, meta, payload


def block_from_frame(meta: dict, payload: bytes) -> RowBlock:
    """Rebuild the RowBlock a BLOCK frame carries; the arrays are
    zero-copy views over ``payload`` (pinned via ``hold``), and the
    stored resume annotation is re-attached verbatim."""
    t0 = get_time()
    segments = read_segments(payload, meta["arrays"])
    block = RowBlock.from_segments(segments, hold=payload)
    resume = meta.get("resume")
    if resume is not None:
        block.resume_state = resume
    _telemetry.record_span("service_decode", t0, get_time() - t0,
                           rows=len(block))
    return block


# ---------------- socket plumbing ----------------

def recvall_into(sock, buf: memoryview) -> None:
    """Fill ``buf`` exactly via ``recv_into``; a peer hangup mid-message
    raises ConnectionError (retryable — the client fails over)."""
    nread = 0
    nbytes = buf.nbytes
    while nread < nbytes:
        got = sock.recv_into(buf[nread:], min(nbytes - nread, 1 << 20))
        if not got:
            raise ConnectionError("service: peer closed mid-frame")
        nread += got


def recvall(sock, nbytes: int) -> bytearray:
    """Read exactly ``nbytes`` into one preallocated buffer (no
    chunk-list join; the quadratic-ish copying is gone)."""
    buf = bytearray(nbytes)
    recvall_into(sock, memoryview(buf))
    return buf


def send_frame(sock, frame: bytes) -> None:
    """Ship one encoded frame (``service_send`` span)."""
    t0 = get_time()
    sock.sendall(frame)
    _telemetry.record_span("service_send", t0, get_time() - t0,
                           nbytes=len(frame))


def send_frame_vectored(sock, buffers) -> int:
    """Ship one frame given as scatter buffers — the worker's v2 send
    path hands the mmap'd payload span straight to ``sendmsg`` instead
    of re-buffering it next to the header. Falls back to per-buffer
    ``sendall`` on sockets without ``sendmsg``. Returns bytes sent."""
    t0 = get_time()
    views = [memoryview(b).cast("B") for b in buffers if len(b)]
    total = sum(v.nbytes for v in views)
    if hasattr(sock, "sendmsg"):
        while views:
            sent = sock.sendmsg(views)
            while sent:
                if views[0].nbytes <= sent:
                    sent -= views[0].nbytes
                    views.pop(0)
                else:
                    views[0] = views[0][sent:]
                    sent = 0
    else:  # pragma: no cover - sendmsg exists on all posix pythons
        for v in views:
            sock.sendall(v)
    _telemetry.record_span("service_send", t0, get_time() - t0,
                           nbytes=total)
    return total


def recv_frame(sock) -> Tuple[int, dict, bytes]:
    """Read one frame off the socket (``service_recv`` span covers the
    wire wait; decode is spanned separately by :func:`block_from_frame`).

    The frame lands in ONE preallocated buffer: the 20-byte header is
    read first (to size the allocation), copied in, and the body is
    ``recv_into`` the remainder — no ``header + rest`` concat copy."""
    t0 = get_time()
    header = recvall(sock, HEADER_LEN)
    magic, version, kind, meta_len, payload_len = struct.unpack(
        _HEADER_FMT, bytes(header))
    if magic != FRAME_MAGIC or version not in (FRAME_VERSION,
                                               FRAME_VERSION_2):
        raise ServiceFrameError(
            f"service frame: bad header (magic {magic!r} version {version})")
    if meta_len + payload_len > MAX_FRAME_BYTES:
        raise ServiceFrameError(
            f"service frame: implausible length {meta_len + payload_len}")
    body_len = meta_len + payload_len + _CRC_LEN
    frame = bytearray(HEADER_LEN + body_len)
    frame[:HEADER_LEN] = header
    recvall_into(sock, memoryview(frame)[HEADER_LEN:])
    _telemetry.record_span("service_recv", t0, get_time() - t0,
                           nbytes=len(frame))
    return decode_frame(frame)
