"""Chunk-cache decorator for input splits (``#cachefile``).

Own copy of the JAX package's ``io/cached_split.py``, the equivalent of
reference src/io/cached_input_split.h: the first pass serves chunks while
writing them to a local cache file; later passes stream straight from the
cache (InitCachedIter, cached_input_split.h:166-189) and never open the
source. Selected by a ``#cachefile`` URI suffix (src/io.cc:119-123) with
the partition-qualified ``.splitN.partK`` name from
:class:`~dmlc_tpu_torch.io.uri.URISpec`.

- The cache is staged to a store-allocated ``.tmp``, fsynced and
  atomically published through the tiered artifact store
  (:mod:`dmlc_tpu_torch.store`: manifest record, byte budget, orphan
  GC), so a crashed first pass never leaves a truncated cache; a warm
  pass pins the cache, so a budget squeeze cannot evict it mid-epoch.
- Format v1 (``DMLCCHK1`` header, then ``[u64 size][u32 crc32][bytes]``
  frames) is the JAX package's, byte for byte: a cache written by either
  package serves in the other. A warm pass verifies every frame; a bad
  frame is a cache fault (:class:`~dmlc_tpu_torch.utils.check.\
CacheCorruptionError`): the cache is discarded, the stream goes on from
  the source where it broke, the cache is rewritten, and the event counts
  under ``cache_corruptions`` / ``cache_rebuilds``. A headerless or
  foreign-headed file invalidates at open (``cache_invalidations``).

Every warm frame read first passes through the fault-injection seam
(``faults.maybe_fail("cache_read", cache_file)``), so a ``cache_read``
plan drives the same healing path as a damaged frame.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Iterator, Optional

from dmlc_tpu_torch.io import faults as _faults
from dmlc_tpu_torch.io import resilience as _resilience
from dmlc_tpu_torch.io.input_split import InputSplit, InputSplitBase, _Chunk
from dmlc_tpu_torch.io.threaded_iter import ThreadedIter
from dmlc_tpu_torch.utils.check import CacheCorruptionError, DMLCError, check

CHUNK_CACHE_MAGIC = b"DMLCCHK1"
_FRAME_FMT = "<QI"  # payload size, payload crc32
_FRAME_LEN = struct.calcsize(_FRAME_FMT)


class CachedInputSplit(InputSplit):
    """Serve-and-cache on the first pass, cache-only afterwards.

    ``base`` may be a live InputSplitBase or a zero-arg factory for one; the
    factory is only invoked when the cache is missing (or needs a healing
    rebuild), so a healthy warm cache never touches the source filesystem
    (the files may be gone or remote).
    """

    def __init__(self, base, cache_file: str, capacity: int = 16,
                 splitter_cls=None):
        self._base_factory = base if callable(base) else (lambda: base)
        self._base: Optional[InputSplitBase] = base if not callable(base) else None
        self._splitter_cls = splitter_cls or (type(self._base) if self._base else None)
        check(self._splitter_cls is not None,
              "CachedInputSplit: a factory base requires splitter_cls for "
              "cache-only record extraction")
        self._detached: Optional[InputSplitBase] = None
        self.cache_file = cache_file
        self._tmp_file: Optional[str] = None  # store-allocated per pass
        self._capacity = capacity
        self._chunk: Optional[_Chunk] = None
        self._iter: Optional[ThreadedIter] = None
        self._pinned = False
        self._mode = "cached" if self._cache_usable() else "preproc"
        if self._mode == "cached":
            self._pin_cache()
        self._start_iter()

    def _store(self):
        from dmlc_tpu_torch.io.block_cache import _artifact_store

        return _artifact_store(self.cache_file)

    def _pin_cache(self) -> None:
        """Eviction pin: while this split serves the
        cache, a byte-budget squeeze may never evict it."""
        if not self._pinned:
            self._store().pin(self.cache_file)
            self._pinned = True

    def _unpin_cache(self) -> None:
        if self._pinned:
            self._pinned = False
            try:
                self._store().drop(self.cache_file)
            except OSError:
                pass

    def _cache_usable(self) -> bool:
        """A published cache with the current format header. A header from
        another format/version (including the headerless v0 layout) is a
        stale cache: drop it and rebuild from source."""
        if not os.path.exists(self.cache_file):
            # an eviction-vanished cache heals via rebuild; the store
            # counts store_rebuilds_after_eviction. The
            # light probe never creates state for an unmanaged dir.
            from dmlc_tpu_torch.io.block_cache import _store_manager

            _store_manager().note_missing(self.cache_file)
            return False
        try:
            with open(self.cache_file, "rb") as fi:
                head = fi.read(len(CHUNK_CACHE_MAGIC))
        except OSError:
            head = b""
        if head == CHUNK_CACHE_MAGIC:
            return True
        _resilience.record_event("cache_invalidations")
        self._unpin_cache()
        self._store().discard(self.cache_file)
        return False

    @property
    def base(self) -> InputSplitBase:
        if self._base is None:
            self._base = self._base_factory()
        return self._base

    def _extractor(self) -> InputSplitBase:
        """Record extraction without touching the source filesystem.

        extract_next_record is stateless by design (operates only on the
        chunk), so a detached instance created without __init__ suffices in
        cache-only mode.
        """
        if self._base is not None:
            return self._base
        if self._detached is None:
            self._detached = object.__new__(self._splitter_cls)
        return self._detached

    # ---------------- producers ----------------

    def _preproc_chunks(self) -> Iterator[bytes]:
        """First pass: pull from base, tee every chunk to the cache file."""
        store = self._store()
        self._tmp_file = store.stage_path(self.cache_file)
        with open(self._tmp_file, "wb") as fo:
            fo.write(CHUNK_CACHE_MAGIC)
            while True:
                chunk = self.base.next_chunk()
                if chunk is None:
                    break
                data = bytes(chunk) if not isinstance(chunk, bytes) else chunk
                fo.write(struct.pack(_FRAME_FMT, len(data),
                                     zlib.crc32(data) & 0xFFFFFFFF))
                fo.write(data)
                yield data
            # atomic publish through the store: fsync BEFORE the rename
            # (a crash in the window can never publish a complete-looking
            # cache whose frames were never flushed), manifest record,
            # byte-budget enforcement
            store.publish_file(self._tmp_file, self.cache_file,
                               tier="chunk_cache", fobj=fo)
        self._tmp_file = None
        self._mode = "cached"
        self._pin_cache()

    def _cached_chunks(self) -> Iterator[bytes]:
        served_bytes = 0
        try:
            with open(self.cache_file, "rb") as fi:
                head = fi.read(len(CHUNK_CACHE_MAGIC))
                if head != CHUNK_CACHE_MAGIC:
                    raise CacheCorruptionError(
                        f"{self.cache_file}: bad chunk-cache header")
                while True:
                    _faults.maybe_fail("cache_read", self.cache_file)
                    header = fi.read(_FRAME_LEN)
                    if not header:
                        return
                    if len(header) != _FRAME_LEN:
                        raise CacheCorruptionError(
                            f"{self.cache_file}: torn frame header")
                    size, crc = struct.unpack(_FRAME_FMT, header)
                    data = fi.read(size)
                    if len(data) != size:
                        raise CacheCorruptionError(
                            f"{self.cache_file}: torn frame payload")
                    if zlib.crc32(data) & 0xFFFFFFFF != crc:
                        raise CacheCorruptionError(
                            f"{self.cache_file}: frame crc mismatch")
                    yield data
                    served_bytes += size
        except CacheCorruptionError:
            # classified cache fault (resilience.classify -> retryable):
            # drop the bad cache, fall back to re-reading the source,
            # rewrite the cache, and resume the stream where it broke —
            # consumers see an unbroken chunk sequence, never the error.
            # The resume skips BYTES, not frames: the re-read may group
            # chunks differently (e.g. the split's chunk_bytes changed
            # since the cache was built) but the concatenated byte stream
            # is identical, and every frame boundary sits on a record
            # boundary, so a mid-chunk tail still starts at a record head
            _resilience.record_event("cache_corruptions")
            _resilience.record_event("cache_rebuilds")
            self._unpin_cache()
            self._store().discard(self.cache_file)
            self._mode = "preproc"
            self.base.before_first()
            skip = served_bytes
            for data in self._preproc_chunks():
                if skip >= len(data):
                    skip -= len(data)
                    continue
                if skip:
                    data = data[skip:]
                    skip = 0
                yield data

    def _start_iter(self) -> None:
        if self._iter is not None:
            self._iter.destroy()
        factory = self._preproc_chunks if self._mode == "preproc" else self._cached_chunks
        self._iter = ThreadedIter.from_factory(factory, max_capacity=self._capacity)

    # ---------------- consumer ----------------

    def next_chunk(self) -> Optional[memoryview]:
        if self._chunk is not None and not self._chunk.exhausted:
            out = self._chunk.data[self._chunk.pos:]
            self._chunk = None
            return out
        data = self._iter.next()
        return memoryview(data) if data is not None else None

    def next_record(self) -> Optional[memoryview]:
        while True:
            if self._chunk is not None:
                rec = self._extractor().extract_next_record(self._chunk)
                if rec is not None:
                    return rec
            data = self._iter.next()
            if data is None:
                return None
            self._chunk = _Chunk(data)

    def before_first(self) -> None:
        self._chunk = None
        if self._mode == "preproc":
            # first pass was interrupted mid-write: drop the partial
            # staging file and restart the pass (the stage/publish
            # protocol keeps the real cache file untouched)
            self._iter.destroy()
            self._drop_tmp()
            self.base.before_first()
            self._start_iter()
        else:
            self._start_iter()

    def reset_partition(self, part_index: int, num_parts: int) -> None:
        raise DMLCError(
            "CachedInputSplit does not support reset_partition; the cache is "
            "bound to one partition (cached_input_split.h:87-89)")

    def hint_chunk_size(self, chunk_size: int) -> None:
        if self._base is not None:
            self._base.hint_chunk_size(chunk_size)

    def _drop_tmp(self) -> None:
        tmp, self._tmp_file = self._tmp_file, None
        if tmp is not None:
            try:
                os.remove(tmp)
            except OSError:
                pass

    def close(self) -> None:
        if self._iter is not None:
            self._iter.destroy()
        if self._base is not None:
            self._base.close()
        self._unpin_cache()
        self._drop_tmp()
