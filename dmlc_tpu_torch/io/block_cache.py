"""The DMLC segment container, and the parse-once block cache built on it.

Own copy of the JAX package's ``io/block_cache.py``: the container
machinery the snapshot store (:mod:`dmlc_tpu_torch.io.snapshot`) shares,
and the block cache's writer, reader and open helper. The bytes on disk are
the same, so a container written by either package opens in the other::

    [header]   8-byte magic + u32 LE version + 4 zero pad bytes
    [segments] per record, its arrays: each start padded to 64-byte
               alignment, raw little-endian C-order bytes, one crc32
               rolling over padding + payload
    [footer]   utf-8 JSON (sort_keys, compact separators)
    [tail]     u64 footer_offset + u64 footer_len + u32 footer_crc LE
               + the magic again

The block cache (magic ``DMLCBC01``, pinned by
``tests/data/blockcache_v1.golden``) stores parsed RowBlocks as the named
segments :data:`SEGMENT_NAMES`, one record a block, each with its crc32
over ``[pos, end)``, its row count and its resume annotation; its footer is
``{"version", "signature", "num_col", "rows", "blocks": [{"pos", "end",
"rows", "crc", "resume", "arrays": {name: [dtype_str, abs_offset,
nbytes]}}, ...]}``. The pipeline half, ``BlockCacheIter``, lives in
:mod:`dmlc_tpu_torch.data.parsers`. A cache is bound to a source
signature (:func:`source_signature`); :func:`open_block_cache` returns
None for a missing, unreadable or stale cache and removes the stale file,
so the caller rebuilds. The pre-encoded span paths
(:meth:`BlockCacheWriter.add_block_encoded`,
:meth:`BlockCacheReader.block_encoded`) serve the ``native-batch`` engine
(:mod:`dmlc_tpu_torch.data.batch_parser`): its blocks reach the file with
no re-encode, and a warm block carries its span.

bfloat16 without ``ml_dtypes``: a segment stored under the dtype string
``"bfloat16"`` reads on the host as ``uint16`` words (the same bytes), and
the device side views them as ``torch.bfloat16``. The writer takes a
``torch.bfloat16`` tensor and stores it under that name, as the JAX writer
stores an ``ml_dtypes`` array.

Publishing goes through the tiered artifact store
(:mod:`dmlc_tpu_torch.store`): a writer streams to the store's staging
name ``<path>.<pid>.<seq>.tmp`` (:meth:`ArtifactStore.stage_path`), and
:func:`finish_container` hands it to :meth:`ArtifactStore.publish_file`
(fsync, atomic rename, a manifest record, the byte budget), so a crash
never leaves a torn file under ``path``. A reader pins the file it serves
and drops the pin at close, so a budget squeeze cannot evict it
mid-epoch; a stale or corrupt file is discarded through the store
(no tombstone: an invalidation is not an eviction).
"""

from __future__ import annotations

import json
import mmap
import os
import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from dmlc_tpu_torch.io import resilience as _resilience
from dmlc_tpu_torch.io.filesystem import get_filesystem
from dmlc_tpu_torch.io.uri import URI
from dmlc_tpu_torch.utils import telemetry as _telemetry
from dmlc_tpu_torch.utils.check import CacheCorruptionError, DMLCError, check
from dmlc_tpu_torch.utils.timer import get_time

BLOCK_CACHE_MAGIC = b"DMLCBC01"
BLOCK_CACHE_VERSION = 1  # also the version source signatures carry
_TAIL_FMT = "<QQI"  # footer offset, footer length, footer crc32
_TAIL_LEN = struct.calcsize(_TAIL_FMT) + 8
_ALIGN = 64
_BF16 = "bfloat16"
# a block's segments in their canonical order (fixed, so the layout is
# deterministic); optional arrays are absent from a block's footer entry
SEGMENT_NAMES = ("offset", "label", "weight", "qid", "field", "index", "value")


def _store_manager():
    """The tiered-store manager module, bound at call time: it sits above
    the resilience and telemetry layers this module imports."""
    from dmlc_tpu_torch.store import manager

    return manager


def _artifact_store(path: str):
    """The :class:`~dmlc_tpu_torch.store.manager.ArtifactStore` owning
    ``path``'s directory."""
    return _store_manager().store_for(path)


def container_header(magic: bytes, version: int) -> bytes:
    """8-byte magic + u32 LE version + 4 zero pad bytes."""
    check(len(magic) == 8, "container magic must be 8 bytes")
    return magic + struct.pack("<I", version) + b"\0" * 4


def _pad_to(f, align: int) -> int:
    pos = f.tell()
    rem = pos % align
    if rem:
        f.write(b"\0" * (align - rem))
        pos += align - rem
    return pos


def _host_bytes(arr) -> Tuple[bytes, str]:
    """The canonical little-endian payload of ``arr`` and its stored dtype
    string: numpy's ``.str`` for numpy dtypes, ``"bfloat16"`` for a
    ``torch.bfloat16`` tensor."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().tobytes(), _BF16
        arr = t.numpy()
    arr = np.ascontiguousarray(arr)
    check(arr.dtype.kind != "V", f"unsupported segment dtype {arr.dtype}")
    return arr.tobytes(), arr.dtype.str


def write_segments(f, segments: Dict[str, object], names=SEGMENT_NAMES) -> tuple:
    """Serialize the present ``names`` arrays (numpy arrays or CPU tensors)
    at ``f``'s current position: canonical order, each start padded to 64
    bytes, one crc32 over padding and payload. Returns ``(end, crc,
    arrays)`` with ``arrays`` mapping name -> ``[dtype_str, abs_offset,
    nbytes]``."""
    arrays: Dict[str, list] = {}
    crc = 0
    for name in names:
        arr = segments.get(name)
        if arr is None:
            continue
        start = f.tell()
        rem = start % _ALIGN
        if rem:
            padding = b"\0" * (_ALIGN - rem)
            f.write(padding)
            crc = zlib.crc32(padding, crc)
            start += len(padding)
        raw, dtype_str = _host_bytes(arr)
        f.write(raw)
        crc = zlib.crc32(raw, crc)
        arrays[name] = [dtype_str, start, len(raw)]
    return f.tell(), crc & 0xFFFFFFFF, arrays


def _segment_dtype(dtype_str: str) -> np.dtype:
    """The host dtype a stored segment reads as; ``"bfloat16"`` reads as
    ``uint16`` words."""
    if dtype_str == _BF16:
        return np.dtype(np.uint16)
    return np.dtype(dtype_str)


def torch_dtype(dtype_str: str) -> torch.dtype:
    """The device dtype of a stored segment (``"bfloat16"`` included)."""
    if dtype_str == _BF16:
        return torch.bfloat16
    return torch.from_numpy(np.empty(0, np.dtype(dtype_str))).dtype


def read_segments(buf, arrays: Dict[str, list]) -> Dict[str, np.ndarray]:
    """{name: zero-copy numpy view over ``buf``} for a
    :func:`write_segments` ``arrays`` mapping."""
    out: Dict[str, np.ndarray] = {}
    for name, (dtype_str, off, nbytes) in arrays.items():
        dt = _segment_dtype(dtype_str)
        out[name] = np.frombuffer(buf, dtype=dt, count=nbytes // dt.itemsize,
                                  offset=int(off))
    return out


def span_layout(arrays: Dict[str, list], shapes=None, base: int = 0):
    """A record's ``arrays`` (+ optional ``shapes``) mapping as a hashable
    span layout ``((name, dtype_str, rel_offset, nbytes, shape), ...)``,
    offsets rebased to ``base`` — what
    :func:`dmlc_tpu_torch.ops.device_decode.decode_span` slices a
    verbatim-copied u8 span by."""
    entries = []
    for name, (dtype_str, off, nbytes) in arrays.items():
        shape = (shapes or {}).get(name)
        dt = _segment_dtype(dtype_str)
        shape = (tuple(int(d) for d in shape) if shape is not None
                 else (int(nbytes) // dt.itemsize,))
        entries.append((str(name), str(dtype_str), int(off) - int(base),
                        int(nbytes), shape))
    return tuple(entries)


def finish_container(f, tmp_path: str, path: str, footer: dict,
                     magic: bytes) -> None:
    """Write the crc'd JSON ``footer``, the tail record and the closing
    ``magic``, then publish ``tmp_path`` at ``path`` through the artifact
    store (fsync + atomic rename + manifest record + byte budget) under the
    tier its magic names."""
    payload = json.dumps(footer, sort_keys=True, separators=(",", ":")).encode()
    off = _pad_to(f, _ALIGN)
    f.write(payload)
    f.write(struct.pack(_TAIL_FMT, off, len(payload), zlib.crc32(payload) & 0xFFFFFFFF))
    f.write(magic)
    _artifact_store(path).publish_file(
        tmp_path, path, tier=_store_manager().tier_for_magic(magic),
        signature=footer.get("signature"), fobj=f)


def open_container(path: str, magic: bytes, version: int, what: str):
    """mmap a published container and verify its structure (header magic
    and version, tail magic, footer crc). Returns ``(file, mmap,
    footer_dict)``; raises :class:`DMLCError`, with the file closed, on any
    structural problem."""
    header = container_header(magic, version)
    f = mm = None
    try:
        size = os.path.getsize(path)
        check(size >= len(header) + _TAIL_LEN, f"{what}: too short")
        f = open(path, "rb")
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    except (OSError, DMLCError) as exc:
        if mm is not None:
            mm.close()
        if f is not None:
            f.close()
        raise DMLCError(f"{what}: unreadable: {exc}") from exc
    try:
        head = mm[: len(header)]
        check(head[:8] == magic, f"{what}: bad magic")
        (ver,) = struct.unpack("<I", head[8:12])
        check(ver == version, f"{what}: version {ver} != {version}")
        tail = mm[size - _TAIL_LEN:]
        check(tail[-8:] == magic, f"{what}: truncated (no tail magic)")
        off, length, crc = struct.unpack(_TAIL_FMT, tail[: struct.calcsize(_TAIL_FMT)])
        check(off + length <= size - _TAIL_LEN, f"{what}: footer out of range")
        payload = mm[off: off + length]
        check(zlib.crc32(payload) & 0xFFFFFFFF == crc, f"{what}: footer crc mismatch")
        return f, mm, json.loads(payload)
    except Exception:
        mm.close()
        f.close()
        raise


def _normalize(obj):
    """JSON round-trip: the stored signature is what JSON preserves."""
    return json.loads(json.dumps(obj, sort_keys=True))


def source_signature(uri: str, part_index: int, num_parts: int, **config) -> dict:
    """The staleness key a container is bound to: the source files with
    sizes and mtimes, the partition, and the parser ``config``. A file on
    another registered filesystem (``mem://``) carries its size from the
    filesystem and no mtime, a directory its listing; an unreachable one
    its path alone. The dict equals the JAX package's for the same corpus
    and settings."""
    base = uri.split("#", 1)[0].split("?", 1)[0]
    files: List[list] = []
    for part in base.split(";"):
        if not part:
            continue
        local = part[7:] if part.startswith("file://") else (
            part if "://" not in part else None)
        if local is not None:
            if os.path.isdir(local):
                for name in sorted(os.listdir(local)):
                    fp = os.path.join(local, name)
                    if os.path.isfile(fp):
                        st = os.stat(fp)
                        files.append([fp, st.st_size, st.st_mtime_ns])
            elif os.path.exists(local):
                st = os.stat(local)
                files.append([local, st.st_size, st.st_mtime_ns])
            else:
                files.append([part, None, None])
            continue
        try:  # sizes from the filesystem layer, no mtimes
            fs = get_filesystem(part)
            info = fs.get_path_info(URI(part))
            if info.type == "directory":
                for f in fs.list_directory(info.path):
                    if f.type == "file":
                        files.append([str(f.path), f.size, None])
            else:
                files.append([str(info.path), info.size, None])
        except Exception:  # noqa: BLE001 - an unreachable source: its path alone
            files.append([part, None, None])
    return _normalize({
        "cache_version": BLOCK_CACHE_VERSION,
        "files": files,
        "partition": [int(part_index), int(num_parts)],
        "config": config,
    })


# ---------------- the block cache: writer, reader, open helper ----------------


class BlockCacheWriter:
    """Streams checksummed columnar block segments to a staging file;
    :meth:`finish` writes the footer and publishes it at ``path`` through
    the artifact store."""

    def __init__(self, path: str, signature: Optional[dict] = None):
        self.path = path
        self._sig = signature or {}
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        # a process-unique staging name from the store: two writers of one
        # path never share half-written bytes
        self.tmp_path = _artifact_store(path).stage_path(path)
        self._f = open(self.tmp_path, "wb")
        self._f.write(container_header(BLOCK_CACHE_MAGIC, BLOCK_CACHE_VERSION))
        self._entries: List[dict] = []
        self._num_col = 0
        self._rows = 0
        self._finished = False

    def add_block(self, segments: Dict[str, Optional[np.ndarray]], rows: int,
                  num_col: int = 0, resume: Optional[dict] = None) -> None:
        """Append one block. ``segments`` maps :data:`SEGMENT_NAMES` to 1-D
        arrays (None: absent); ``resume`` is the block's JSON-able resume
        annotation (the position just after it), stored so warm epochs
        re-attach the same checkpoint states."""
        check(self._f is not None and not self._finished,
              "BlockCacheWriter: writer already finished/aborted")
        t_span = get_time()
        pos = _pad_to(self._f, _ALIGN)
        end, crc, arrays = write_segments(self._f, segments)
        self._append_entry(t_span, pos, end, crc, arrays, rows, num_col, resume)

    def add_block_encoded(self, encoded, resume: Optional[dict] = None) -> None:
        """Append one pre-encoded block span, an
        :class:`~dmlc_tpu_torch.data.batch_parser.EncodedSegments` (the
        ``native-batch`` engine's): its bytes are the ``[pos, end)`` span
        :meth:`add_block` would write (segment order, 64-byte alignment,
        zero gap bytes), with their crc32 and the footer's ``arrays``, so
        the block goes to disk in one write with no re-encode. The file is
        byte-identical to :meth:`add_block`'s on the same block."""
        check(self._f is not None and not self._finished,
              "BlockCacheWriter: writer already finished/aborted")
        t_span = get_time()
        pos = _pad_to(self._f, _ALIGN)
        self._f.write(encoded.data)
        arrays = {name: [dt, pos + int(off), int(nb)]
                  for name, (dt, off, nb) in encoded.arrays.items()}
        self._append_entry(t_span, pos, pos + int(encoded.nbytes), int(encoded.crc), arrays,
                           encoded.rows, encoded.num_col, resume)

    def _append_entry(self, t_span, pos, end, crc, arrays, rows, num_col, resume) -> None:
        """The bookkeeping both append paths share: the footer entry, the
        totals and the ``cache_write`` span."""
        # through JSON, so cold- and warm-served states compare equal
        self._entries.append({
            "pos": pos, "end": end, "rows": int(rows), "crc": crc,
            "resume": json.loads(json.dumps(resume)) if resume is not None else None,
            "arrays": arrays})
        self._rows += int(rows)
        self._num_col = max(self._num_col, int(num_col))
        # the shadow write's cost, on the trace beside the parse it follows
        _telemetry.record_span("cache_write", t_span, get_time() - t_span, rows=int(rows))

    def finish(self) -> None:
        """Write footer + tail, fsync, and publish at ``path``."""
        check(self._f is not None and not self._finished,
              "BlockCacheWriter: writer already finished/aborted")
        footer = {"version": BLOCK_CACHE_VERSION, "signature": self._sig,
                  "num_col": self._num_col, "rows": self._rows,
                  "blocks": self._entries}
        finish_container(self._f, self.tmp_path, self.path, footer, BLOCK_CACHE_MAGIC)
        self._f = None
        self._finished = True

    def abort(self) -> None:
        """Drop the staging file (an interrupted cold pass)."""
        if self._f is not None:
            self._f.close()
            self._f = None
        try:
            os.remove(self.tmp_path)
        except OSError:
            pass

    def close(self) -> None:
        if not self._finished:
            self.abort()


class BlockCacheReader:
    """mmap-backed reader: a block's segments load as zero-copy read-only
    numpy views.

    The views alias the mmap: a block built on them keeps :attr:`hold`
    (the mmap) alive, and :meth:`close` leaves an mmap with live views to
    the garbage collector instead of closing it under them. The reader
    pins the file in its store while it is open."""

    def __init__(self, path: str, signature: Optional[dict] = None, verify: bool = True):
        self.path = path
        self.verify = verify
        self._store_pinned = False
        self._file, self._mm, footer = open_container(
            path, BLOCK_CACHE_MAGIC, BLOCK_CACHE_VERSION, f"block cache {path}")
        try:
            self.signature = footer.get("signature") or {}
            self.num_col = int(footer.get("num_col", 0))
            self.rows = int(footer.get("rows", 0))
            self._blocks = footer["blocks"]
            if signature is not None and self.signature != _normalize(signature):
                raise DMLCError(f"block cache {path}: source signature mismatch (stale cache)")
            # while this reader serves the cache, a budget squeeze may not
            # evict it; the pin drops at close()
            _artifact_store(path).pin(path)
            self._store_pinned = True
        except Exception:
            self.close()
            raise

    @property
    def num_blocks(self) -> int:
        return len(self._blocks)

    @property
    def hold(self):
        """The buffer owner views must keep alive (the mmap)."""
        return self._mm

    def resume(self, i: int) -> Optional[dict]:
        """Block ``i``'s stored resume annotation, or None."""
        return self._blocks[i]["resume"]

    def block_rows(self, i: int) -> int:
        return int(self._blocks[i]["rows"])

    def block_nbytes(self, i: int) -> int:
        e = self._blocks[i]
        return int(e["end"]) - int(e["pos"])

    def load_segments(self, i: int, copy: bool = False) -> Dict[str, np.ndarray]:
        """Block ``i`` as {name: zero-copy read-only numpy view}, its crc32
        checked first (``verify``); ``copy=True`` copies the arrays into
        process memory instead (no :attr:`hold` needed), so a permuted
        read's page faults land in the caller's timed read. Raises
        :class:`CacheCorruptionError` on a crc mismatch."""
        entry = self._blocks[i]
        if self.verify:
            # a memoryview slice does not copy the span, as an mmap slice would
            with memoryview(self._mm)[int(entry["pos"]): int(entry["end"])] as span:
                ok = zlib.crc32(span) & 0xFFFFFFFF == int(entry["crc"])
            if not ok:
                raise CacheCorruptionError(f"block cache {self.path}: crc mismatch on block {i}")
        segments = read_segments(self._mm, entry["arrays"])
        if copy:
            segments = {k: np.array(v) for k, v in segments.items()}
        return segments

    def block_encoded(self, i: int):
        """Block ``i``'s contiguous segment span as an
        :class:`~dmlc_tpu_torch.data.batch_parser.EncodedSegments` view over
        the mmap, with no copy (a block cache tee appends it as it is). The
        view aliases the mmap through ``hold``: keep the reader open while
        it lives."""
        from dmlc_tpu_torch.data.batch_parser import EncodedSegments

        entry = self._blocks[i]
        pos, end = int(entry["pos"]), int(entry["end"])
        arrays = {name: (dt, int(off) - pos, int(nb))
                  for name, (dt, off, nb) in entry["arrays"].items()}
        return EncodedSegments(data=memoryview(self._mm)[pos:end], arrays=arrays,
                               crc=int(entry["crc"]), rows=int(entry["rows"]),
                               num_col=self.num_col, hold=self._mm)

    def close(self) -> None:
        # the pin drops first, even when live views keep the mmap open: an
        # unlinked file stays mapped on POSIX, so the drop is always safe
        if getattr(self, "_store_pinned", False):
            self._store_pinned = False
            try:
                _artifact_store(self.path).drop(self.path)
            except OSError:
                pass
        # an mmap with exported views cannot close (BufferError): the
        # garbage collector reclaims it once the last view is gone
        mm = getattr(self, "_mm", None)
        if mm is not None:
            try:
                mm.close()
                self._mm = None
            except BufferError:
                pass
        f = getattr(self, "_file", None)
        if f is not None:
            self._file = None
            f.close()


def open_block_cache(path: str, signature: Optional[dict] = None,
                     verify: bool = True) -> Optional[BlockCacheReader]:
    """Open a published cache, or None when it is missing or must be
    rebuilt (unreadable, another version, a signature mismatch): the stale
    file is discarded through the store and a ``cache_invalidations``
    event counted. A miss on a path the store's manifest marks as evicted
    counts ``store_rebuilds_after_eviction``: the rebuild the caller now
    runs is the budget's doing."""
    if not os.path.exists(path):
        # consults the store only where the directory already has a manifest
        _store_manager().note_missing(path)
        return None
    try:
        return BlockCacheReader(path, signature=signature, verify=verify)
    except DMLCError:
        _resilience.record_event("cache_invalidations")
        _artifact_store(path).discard(path)
        return None
