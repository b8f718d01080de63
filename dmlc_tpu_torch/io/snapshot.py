"""Snapshot store: post-convert, device-layout batches on disk.

Own copy of the JAX package's ``io/snapshot.py`` (format ``DMLCSN01``,
pinned by ``tests/data/snapshot_v1.golden``). A cold epoch of :class:`~dmlc_tpu_torch.data.device.DeviceIter`
shadow-writes the batches it ships; warm epochs read them back from an
mmap with no parse and no convert::

    [header]   magic "DMLCSN01" + u32 LE version + 4 zero pad bytes
    [segments] per batch, its positional arrays (a0, a1, ...): 64-byte
               aligned starts, raw little-endian C-order bytes, one crc32
               per batch
    [footer]   utf-8 JSON (sort_keys): {"version", "signature",
               "geometry", "rows", "batches": [{"kind", "pos", "end",
               "rows", "crc", "resume", "arrays": {name: [dtype_str,
               abs_offset, nbytes]}, "shapes": {name: [dims...]}}, ...]}
    [tail]     u64 footer_offset + u64 footer_len + u32 footer_crc LE
               + magic "DMLCSN01"

A batch is ``(kind, arr0, arr1, ...)``: ``("dense_packed", xp)``,
``("dense", x, y, w)``, ``("ell", indices, values, label, weight)`` or
``("dense_packed_q8", q8, scale)``. Staleness is two-keyed: the source
``signature`` and the batch ``geometry``; a mismatch in either drops the
file at open (:func:`open_snapshot`) instead of serving wrong batches.
A reader opened with ``verify=True`` (the default) checks each batch's
crc32 on every read and raises
:class:`~dmlc_tpu_torch.utils.check.CacheCorruptionError` on a mismatch;
``verify=False`` skips the crc, as the JAX package's reader does. Every
read first passes through the fault-injection seam
(``faults.maybe_fail("snapshot_read", path)``), verified or not.
"""

from __future__ import annotations

import json
import os
import zlib
from typing import Callable, List, Optional, Tuple

import numpy as np

from dmlc_tpu_torch.io import block_cache as _bc
from dmlc_tpu_torch.io import faults as _faults
from dmlc_tpu_torch.io import resilience as _resilience
from dmlc_tpu_torch.io.threaded_iter import OrderedWorkerPool
from dmlc_tpu_torch.utils import knobs as _knobs
from dmlc_tpu_torch.utils import telemetry as _telemetry
from dmlc_tpu_torch.utils.check import CacheCorruptionError, DMLCError, check
from dmlc_tpu_torch.utils.timer import get_time

SNAPSHOT_MAGIC = b"DMLCSN01"
SNAPSHOT_VERSION = 1

# positional segment names: batch arrays are stored in tuple order
MAX_BATCH_ARRAYS = 8
SNAPSHOT_SEGMENT_NAMES = tuple(f"a{i}" for i in range(MAX_BATCH_ARRAYS))


def quantize_int8(arr) -> Tuple[np.ndarray, np.ndarray]:
    """Per-column symmetric int8 quantization of a 2-D float batch,
    ``(q8, scale)``: :func:`dmlc_tpu_torch.ops.device_decode.quantize_int8`
    under the name the JAX package also gives it here
    (``dmlc_tpu/io/snapshot.py:85``), imported when called."""
    from dmlc_tpu_torch.ops.device_decode import quantize_int8 as _impl

    return _impl(arr)


class SnapshotWriter:
    """Streams checksummed device-layout batches to a staging file;
    :meth:`finish` writes the footer and publishes it at ``path`` through
    the artifact store (:mod:`dmlc_tpu_torch.store`)."""

    def __init__(self, path: str, signature: Optional[dict] = None,
                 geometry: Optional[dict] = None):
        self.path = path
        self._sig = signature or {}
        self._geom = _bc._normalize(geometry or {})
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        # a process-unique staging name from the store
        self.tmp_path = _bc._artifact_store(path).stage_path(path)
        self._f = open(self.tmp_path, "wb")
        self._f.write(_bc.container_header(SNAPSHOT_MAGIC, SNAPSHOT_VERSION))
        self._entries: List[dict] = []
        self._rows = 0

    def add_batch(self, kind: str, arrays, rows: int,
                  resume: Optional[dict] = None) -> None:
        """Append one batch: ``arrays`` is the positional tuple behind
        ``kind`` (numpy arrays or CPU tensors, 2-D allowed: shapes are
        recorded); ``resume`` is stored as the batch's resume annotation."""
        check(self._f is not None, "SnapshotWriter: writer already finished/aborted")
        t_span = get_time()
        check(len(arrays) <= MAX_BATCH_ARRAYS,
              f"SnapshotWriter: batch carries {len(arrays)} arrays (max {MAX_BATCH_ARRAYS})")
        segments = {SNAPSHOT_SEGMENT_NAMES[i]: a.reshape(-1) for i, a in enumerate(arrays)}
        pos = _bc._pad_to(self._f, _bc._ALIGN)
        end, crc, arr_meta = _bc.write_segments(self._f, segments, names=SNAPSHOT_SEGMENT_NAMES)
        self._entries.append({
            "kind": str(kind), "pos": pos, "end": end, "rows": int(rows),
            "crc": crc, "resume": _bc._normalize(resume) if resume is not None else None,
            "arrays": arr_meta,
            "shapes": {SNAPSHOT_SEGMENT_NAMES[i]: list(a.shape) for i, a in enumerate(arrays)},
        })
        self._rows += int(rows)
        _telemetry.record_span("snapshot_write", t_span, get_time() - t_span, rows=int(rows))

    def finish(self) -> None:
        """Write footer and tail, fsync, atomically publish at ``path``."""
        check(self._f is not None, "SnapshotWriter: writer already finished/aborted")
        footer = {"version": SNAPSHOT_VERSION, "signature": self._sig,
                  "geometry": self._geom, "rows": self._rows,
                  "batches": self._entries}
        f, self._f = self._f, None
        _bc.finish_container(f, self.tmp_path, self.path, footer, SNAPSHOT_MAGIC)

    def abort(self) -> None:
        """Drop the partial staging file (an interrupted cold pass)."""
        if self._f is not None:
            self._f.close()
            self._f = None
            try:
                os.remove(self.tmp_path)
            except OSError:
                pass

    def close(self) -> None:
        """Abort a writer that was not finished; a finished one is left as
        it is (JAX's ``SnapshotWriter.close``, ``dmlc_tpu/io/snapshot.py:190``)."""
        self.abort()


class SnapshotReader:
    """mmap-backed reader: batches decode to zero-copy read-only numpy
    views in their stored shapes (bfloat16 segments as ``uint16`` words).
    Views alias the mmap, and :meth:`close` tolerates views still alive.
    The reader pins the file in its store while it is open. ``verify``
    (JAX's keyword, ``dmlc_tpu/io/snapshot.py:206``) checks each batch's
    crc32 on a read."""

    def __init__(self, path: str, signature: Optional[dict] = None,
                 geometry: Optional[dict] = None, verify: bool = True):
        self.path = path
        self.verify = verify
        self._store_pinned = False
        self._file, self._mm, footer = _bc.open_container(
            path, SNAPSHOT_MAGIC, SNAPSHOT_VERSION, f"snapshot {path}")
        try:
            self.signature = footer.get("signature") or {}
            self.geometry = footer.get("geometry") or {}
            self.rows = int(footer.get("rows", 0))
            self._batches = footer["batches"]
            if signature is not None and self.signature != _bc._normalize(signature):
                raise DMLCError(f"snapshot {path}: source signature mismatch (stale snapshot)")
            if geometry is not None and self.geometry != _bc._normalize(geometry):
                raise DMLCError(f"snapshot {path}: batch geometry mismatch "
                                f"(stored {self.geometry})")
            # a warm epoch streaming this snapshot cannot lose it to a
            # budget squeeze; the pin drops at close()
            _bc._artifact_store(path).pin(path)
            self._store_pinned = True
        except Exception:
            self.close()
            raise

    @property
    def num_batches(self) -> int:
        return len(self._batches)

    @property
    def hold(self):
        """The buffer owner the views keep alive (the mmap)."""
        return self._mm

    def kind(self, i: int) -> str:
        """Batch ``i``'s kind (``ell``, ``dense``, ``dense_packed``, ...)."""
        return self._batches[i]["kind"]

    def resume(self, i: int) -> Optional[dict]:
        return self._batches[i]["resume"]

    def batch_rows(self, i: int) -> int:
        return int(self._batches[i]["rows"])

    def batch_nbytes(self, i: int) -> int:
        e = self._batches[i]
        return int(e["end"]) - int(e["pos"])

    def layout(self, i: int):
        """Batch ``i``'s span layout (offsets relative to its ``pos``)."""
        e = self._batches[i]
        return _bc.span_layout(e["arrays"], e.get("shapes"), base=int(e["pos"]))

    def _checked(self, i: int) -> memoryview:
        """Batch ``i``'s ``[pos, end)`` bytes, its crc32 checked first under
        ``verify``."""
        e = self._batches[i]
        span = memoryview(self._mm)[int(e["pos"]): int(e["end"])]
        if self.verify and zlib.crc32(span) & 0xFFFFFFFF != int(e["crc"]):
            span.release()
            raise CacheCorruptionError(f"snapshot {self.path}: crc mismatch on batch {i}")
        return span

    def load_batch(self, i: int, copy: bool = False) -> tuple:
        """Batch ``i`` as ``(kind, arr0, arr1, ...)``: read-only views over
        the mmap in the stored shapes, or with ``copy=True`` arrays of the
        process's own. Raises :class:`CacheCorruptionError` on a crc
        mismatch under ``verify`` (or when a ``snapshot_read`` fault is
        injected)."""
        _faults.maybe_fail("snapshot_read", self.path)
        self._checked(i).release()
        e = self._batches[i]
        segments = _bc.read_segments(self._mm, e["arrays"])
        shapes = e.get("shapes") or {}
        out = []
        for name in SNAPSHOT_SEGMENT_NAMES:
            if name not in segments:
                break
            arr = segments[name]
            shape = shapes.get(name)
            if shape is not None and len(shape) != 1:
                arr = arr.reshape(shape)
            out.append(np.array(arr) if copy else arr)
        return (e["kind"], *out)

    def batch_span(self, i: int, copy: bool = False) -> tuple:
        """Batch ``i`` as its raw container bytes: ``(kind, span, layout)``
        with ``span`` the verbatim ``[pos, end)`` u8 view over the mmap (with
        ``copy=True`` a copy of it) and ``layout`` its :meth:`layout` — the
        device-decode tier's input. crc and fault semantics as
        :meth:`load_batch`."""
        _faults.maybe_fail("snapshot_read", self.path)
        span = np.asarray(self._checked(i))
        if copy:
            span = np.array(span)
        return self._batches[i]["kind"], span, self.layout(i)

    def close(self) -> None:
        # the pin drops first, even with live views (an unlinked file stays
        # mapped on POSIX)
        if getattr(self, "_store_pinned", False):
            self._store_pinned = False
            try:
                _bc._artifact_store(self.path).drop(self.path)
            except OSError:
                pass
        mm = getattr(self, "_mm", None)
        if mm is not None:
            try:
                mm.close()
                self._mm = None
            except BufferError:  # views still alive: GC reclaims the map
                pass
        f = getattr(self, "_file", None)
        if f is not None:
            self._file = None
            f.close()


def open_snapshot(path: str, signature: Optional[dict] = None,
                  geometry: Optional[dict] = None,
                  verify: bool = True) -> Optional[SnapshotReader]:
    """Open a published snapshot, or None when it is missing or must be
    rebuilt (unreadable, wrong version, signature or geometry mismatch):
    a stale file is discarded through the store (a
    ``snapshot_invalidations`` event), so the caller runs a cold pass. A
    miss on a path the store's manifest marks as evicted counts
    ``store_rebuilds_after_eviction``."""
    if not os.path.exists(path):
        # consults the store only where the directory already has a manifest
        _bc._store_manager().note_missing(path)
        return None
    try:
        return SnapshotReader(path, signature=signature, geometry=geometry, verify=verify)
    except DMLCError:
        _resilience.record_event("snapshot_invalidations")
        _bc._artifact_store(path).discard(path)
        return None


class SnapshotIter:
    """The warm feed: a snapshot's batches in a given order, read ahead on
    an :class:`~dmlc_tpu_torch.io.threaded_iter.OrderedWorkerPool` of
    ``read_workers`` threads (``DMLC_TPU_SNAPSHOT_READ_WORKERS``, default
    2) with ``2 × read_workers`` reads ahead, so the reads (mmap fault +
    crc) of later batches overlap the use of batch N.

    ``order`` is an index array (an epoch plan's permutation over batch
    indices) or None for stored order; ``start`` resumes at a position.
    ``next()`` returns ``(host_batch, resume, nbytes)`` with ``host_batch
    = (kind, *arrays)``, in order, or None at the end. ``raw=True`` is the
    device-decode feed: ``host_batch`` is ``("device_span", span, layout,
    kind)``, the batch's verbatim bytes. Each read is recorded as a
    ``snapshot_read`` span (and, under a recording torch profiler, a
    ``dmlc_tpu.snapshot_read`` range, which ``annotate=False``, the JAX
    package's keyword, leaves out) and its seconds passed to ``on_read``.
    ``stage``, the port's own,
    runs on the reading thread as ``stage(pos, host_batch, resume,
    nbytes)``, ``pos`` the serving position, and its result is delivered
    in the item's place (``DeviceIter`` copies the batch into a pinned
    staging slot there). :meth:`resize` changes the read width live (the
    autotuner's ``snapshot_read_workers`` knob).

    The feed pins the snapshot in its store before the pool's first read
    and drops the pin in :meth:`destroy` once the last worker has exited
    (a worker parked on a full staging ring included), so a budget squeeze
    published mid-epoch cannot evict the file its workers map, whatever
    becomes of the reader meanwhile.
    """

    def __init__(self, reader: SnapshotReader, order: Optional[np.ndarray] = None,
                 start: int = 0, read_workers: Optional[int] = None,
                 on_read: Optional[Callable[[float], None]] = None, annotate: bool = True,
                 raw: bool = False, stage: Optional[Callable] = None):
        self.reader = reader
        self._order = order
        self._on_read = on_read
        self._annotate = annotate
        self._raw = raw
        self._stage = stage
        n = reader.num_batches if order is None else len(order)
        workers = _knobs.resolve("snapshot_read_workers", read_workers)
        _bc._artifact_store(reader.path).pin(reader.path)
        self._pinned = True
        self._pool = OrderedWorkerPool(lambda: iter(range(int(start), int(n))), self._read,
                                       num_workers=workers, max_ahead=2 * workers,
                                       counter_label="snapshot_read")

    def resize(self, read_workers: int) -> bool:
        """Resize the read pool live to ``n`` workers with ``2 × n`` reads
        ahead; batches keep their serving order. A ``DeviceIter`` grows its
        staging ring for the wider window first. True."""
        n = max(1, int(read_workers))
        self._pool.resize(n)
        self._pool.set_max_ahead(2 * n)
        return True

    def _read(self, pos: int):
        reader = self.reader
        i = int(pos) if self._order is None else int(self._order[pos])
        t0 = get_time()
        try:
            with _telemetry.profiler_annotation("dmlc_tpu.snapshot_read", self._annotate):
                if self._raw:
                    kind, span, layout = reader.batch_span(i)
                    batch = ("device_span", span, layout, kind)
                else:
                    batch = reader.load_batch(i)
        finally:
            dt = get_time() - t0
            _telemetry.record_span("snapshot_read", t0, dt)
            if self._on_read is not None:
                self._on_read(dt)
        item = (batch, reader.resume(i), reader.batch_nbytes(i))
        return item if self._stage is None else self._stage(pos, *item)

    @property
    def stall_seconds(self) -> float:
        return self._pool.stall_seconds

    @stall_seconds.setter
    def stall_seconds(self, value: float) -> None:
        self._pool.stall_seconds = value

    def next(self):
        return self._pool.next()

    def destroy(self) -> None:
        self._pool.destroy()  # joins every worker
        if self._pinned:
            self._pinned = False
            try:
                _bc._artifact_store(self.reader.path).drop(self.reader.path)
            except OSError:
                pass
