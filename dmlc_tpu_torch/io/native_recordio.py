"""The native RecordIO engines: the read, the framing scan and the
multi-part reassembly run in C++ off the interpreter lock
(``native/src/reader.cc`` formats 4 and 5, ``native/src/recordio.cc``).

Own copy of the JAX package's ``io/native_recordio.py``. Where the
reference stacks a prefetch thread over the RecordIO splitter's chunk scan
(src/io/threaded_input_split.h over src/io/recordio_split.cc), these
classes hand the same pipeline to the native core, one pull a batch of
records:

- :class:`NativeRecordIOSplit`: a local ``.rec`` corpus (``recordio``);
- :class:`NativeIndexedRecordIOSplit`: a local corpus with its index
  (``indexed_recordio``), record-count partitions, shuffled epochs by seek;
- :class:`NativeFeedRecordIOSplit`: a corpus on any other registered
  filesystem (``mem://``), whose partition a feed thread reads through the
  Python splitter and pushes into the native chunk feeder.

:func:`~dmlc_tpu_torch.io.input_split.create_input_split` routes here as
the JAX factory does (the ``*_eligible`` checks; ``?engine=python`` and
``DMLC_TPU_NO_NATIVE_READER`` opt out, :func:`native_engine_enabled`);
everything else, and an engine that fails at construction, takes the
Python splitters, which share the partition rules. The states are the JAX
package's (``kind="records"``, ``kind="indexed_native"``), so a position
taken in either package restores in the other.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

import numpy as np

from dmlc_tpu_torch import native
from dmlc_tpu_torch.io.filesystem import LocalFileSystem, get_filesystem
from dmlc_tpu_torch.io.input_split import DEFAULT_CHUNK_BYTES, InputSplit, RecordIOSplitter
from dmlc_tpu_torch.io.uri import URI
from dmlc_tpu_torch.utils import telemetry as _telemetry
from dmlc_tpu_torch.utils.check import DMLCError, check


def native_engine_enabled(args=None) -> bool:
    """The native routes' one opt-out rule: ``DMLC_TPU_NO_NATIVE_READER``
    set to other than ``0``, or the ``?engine=python`` URI argument."""
    if os.environ.get("DMLC_TPU_NO_NATIVE_READER", "0") not in ("", "0"):
        return False
    return (args or {}).get("engine") != "python"


def _check_part(part_index: int, num_parts: int) -> None:
    check(num_parts >= 1, f"num_parts must be >= 1, got {num_parts}")
    check(0 <= part_index < num_parts,
          f"part_index {part_index} out of range for {num_parts} parts")


def _is_local(uri: str) -> Optional[bool]:
    """Whether ``uri`` is on the local filesystem; None for an unknown
    protocol."""
    try:
        return isinstance(get_filesystem(uri), LocalFileSystem)
    except DMLCError:
        return None


def native_recordio_eligible(uri: str, threaded: bool, *, index_uri=None,
                             shuffle: bool = False, num_shuffle_parts: int = 0,
                             cache_file=None, recurse_directories: bool = False) -> bool:
    """Whether ``create_input_split`` can route ``recordio`` to
    :class:`NativeRecordIOSplit`: threaded, undecorated, local."""
    if not threaded or index_uri or shuffle or num_shuffle_parts or cache_file:
        return False
    return bool(_is_local(uri)) and native.available()


def _list_records(uri: str, recurse_directories: bool):
    """``(paths, sizes)`` with the Python engine's file matching (``;``
    lists, directories, regex basenames) and its 4-byte alignment check."""
    lister = RecordIOSplitter(uri, None, recurse_directories=recurse_directories)
    try:
        return ([info.path.name for info in lister.files],
                [info.size for info in lister.files])
    finally:
        lister.close()


class _RecordCursorSplit(InputSplit):
    """The record cursor over native ``(payload, offsets)`` batches that
    every native RecordIO split shares: the walk, the counters and the
    bytes read."""

    _reader = None

    def _cursor_clear(self) -> None:
        self._payload: Optional[np.ndarray] = None
        self._offsets: Optional[np.ndarray] = None
        self._i = 0
        self._records_out = 0

    def _prepare_records(self) -> None:
        """Hook: put the reader in record mode (lazily)."""

    def _pull_batch(self):
        """The next ``(payload, offsets)`` batch, None at the end."""
        raise NotImplementedError

    def next_record(self) -> Optional[memoryview]:
        self._prepare_records()
        while self._offsets is None or self._i >= len(self._offsets) - 1:
            nxt = self._pull_batch()
            if nxt is None:
                return None
            self._payload, self._offsets = nxt
            self._i = 0
        s = int(self._offsets[self._i])
        e = int(self._offsets[self._i + 1])
        self._i += 1
        self._records_out += 1
        return memoryview(self._payload)[s:e]

    @property
    def bytes_read(self) -> int:
        return self._reader.bytes_read if self._reader is not None else 0

    def close(self) -> None:
        if self._reader is not None:
            self._reader.close()
            self._reader = None


class NativeRecordIOSplit(_RecordCursorSplit):
    """An input split over the native RecordIO reader. It serves records
    (payloads, multi-part records joined) or raw record-aligned chunks,
    whichever the consumer asks for first: the two are distinct native
    formats, so mixing them within one epoch raises."""

    def __init__(self, uri: str, part_index: int, num_parts: int,
                 recurse_directories: bool = False, chunk_bytes: int = DEFAULT_CHUNK_BYTES,
                 queue_depth: int = 4):
        _check_part(part_index, num_parts)
        check(_is_local(uri), "native recordio split requires local files")
        self.paths, self.sizes = _list_records(uri, recurse_directories)
        self.part_index = part_index
        self.num_parts = num_parts
        self.chunk_bytes = chunk_bytes
        self.queue_depth = queue_depth
        self._mode: Optional[int] = None  # FMT_RECORDIO or FMT_RECORDIO_CHUNK
        self._reader = None
        self._cursor_clear()

    def _ensure_reader(self, fmt: int):
        if self._reader is None:
            self._mode = fmt
            self._reader = native.Reader(self.paths, self.sizes, self.part_index,
                                         self.num_parts, fmt, chunk_bytes=self.chunk_bytes,
                                         queue_depth=self.queue_depth)
        elif self._mode != fmt:
            raise DMLCError("native recordio split: next_record and next_chunk cannot "
                            "be mixed within one epoch")
        return self._reader

    def _prepare_records(self) -> None:
        self._ensure_reader(native.FMT_RECORDIO)

    def _pull_batch(self):
        nxt = self._reader.next()
        return None if nxt is None else nxt[1]

    def next_chunk(self) -> Optional[memoryview]:
        self._ensure_reader(native.FMT_RECORDIO_CHUNK)
        nxt = self._pull_batch()
        if nxt is None:
            return None
        self._payload, self._offsets = nxt
        self._i = 0
        self._records_out += 1
        return memoryview(self._payload)

    def before_first(self) -> None:
        if self._reader is not None:
            self._reader.before_first()
        self._cursor_clear()
        self._mode = None if self._reader is None else self._mode

    def reset_partition(self, part_index: int, num_parts: int) -> None:
        _check_part(part_index, num_parts)
        self.close()
        self.part_index = part_index
        self.num_parts = num_parts
        self._mode = None
        self._cursor_clear()

    def hint_chunk_size(self, chunk_size: int) -> None:
        if chunk_size > self.chunk_bytes:
            self.chunk_bytes = chunk_size

    # ---------------- checkpoints (a count, as NativeStreamParser's) ----------------

    def state_dict(self) -> dict:
        return {"kind": "records", "records": self._records_out, "mode": self._mode}

    def load_state(self, state: dict) -> None:
        check(state.get("kind") == "records", "incompatible split state")
        self.before_first()
        n = int(state["records"])
        chunks = state.get("mode") == native.FMT_RECORDIO_CHUNK
        for _ in range(n):
            if (self.next_chunk() if chunks else self.next_record()) is None:
                break
        self._records_out = n


def native_indexed_eligible(uri: str, index_uri: str, threaded: bool, *,
                            num_shuffle_parts: int = 0, cache_file=None) -> bool:
    """Whether ``create_input_split`` can route ``indexed_recordio`` to
    :class:`NativeIndexedRecordIOSplit` (shuffle included): threaded,
    undecorated, corpus and index local."""
    if not threaded or num_shuffle_parts or cache_file:
        return False
    if not (_is_local(uri) and _is_local(index_uri)):
        return False
    return native.available()


class NativeIndexedRecordIOSplit(_RecordCursorSplit):
    """An input split over the native indexed RecordIO reader:
    record-count partitions, batched contiguous reads and per-epoch
    shuffled seeks, all in C++ (reader.cc IndexedReader;
    indexed_recordio_split.cc:12-233). The sequential order is the Python
    splitter's record for record; a shuffled order is fixed by (seed,
    epoch) through mt19937_64 and differs from the Python splitter's
    ``random.Random`` permutation, as in the JAX package."""

    # bytes a read batch aims at: bounds the producer's buffers
    BATCH_BYTES_TARGET = 4 << 20

    def __init__(self, uri: str, index_uri: str, part_index: int, num_parts: int,
                 batch_size: int = 256, shuffle: bool = False, seed: int = 0,
                 recurse_directories: bool = False, queue_depth: int = 4):
        from dmlc_tpu_torch.io.recordio import read_index_file

        _check_part(part_index, num_parts)
        check(_is_local(uri), "native indexed recordio split requires local files")
        self.paths, self.sizes = _list_records(uri, recurse_directories)
        index = URI(index_uri)
        with get_filesystem(index).open_for_read(index) as f:
            self.index = read_index_file(f, sum(self.sizes))
        self.part_index = part_index
        self.num_parts = num_parts
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.queue_depth = queue_depth
        self._reader = None
        self._cursor_clear()
        self._epochs = 0

    def _effective_batch_records(self) -> int:
        total = sum(size for _, size in self.index)
        avg = max(1, total // max(1, len(self.index)))
        cap = max(1, self.BATCH_BYTES_TARGET // avg)
        return max(1, min(self.batch_size, cap))

    def _ensure_reader(self):
        if self._reader is None:
            self._reader = native.IndexedReader(
                self.paths, self.sizes, [off for off, _ in self.index], self.part_index,
                self.num_parts, batch_records=self._effective_batch_records(),
                shuffle=self.shuffle, seed=self.seed, queue_depth=self.queue_depth)
        return self._reader

    def _prepare_records(self) -> None:
        self._ensure_reader()

    def _pull_batch(self):
        return self._reader.next()

    def next_chunk(self) -> Optional[memoryview]:
        raise DMLCError("indexed recordio serves records, not raw chunks "
                        "(reference NextChunk is record-batched here too)")

    def before_first(self) -> None:
        if self._reader is not None:
            self._reader.before_first()
            self._epochs += 1
        self._cursor_clear()

    def reset_partition(self, part_index: int, num_parts: int) -> None:
        _check_part(part_index, num_parts)
        self.close()
        self.part_index = part_index
        self.num_parts = num_parts
        self._cursor_clear()
        self._epochs = 0

    def hint_chunk_size(self, chunk_size: int) -> None:
        pass  # the batches are counted in records

    # ---------------- checkpoints ----------------
    # A shuffled epoch is a function of (seed, epoch), so the reader lands
    # on (epoch, record) by replaying the generator and one seek, reading
    # no prefix (dmlc_indexed_reader_skip).

    def state_dict(self) -> dict:
        return {"kind": "indexed_native", "records": self._records_out,
                "epochs": self._epochs}

    def load_state(self, state: dict) -> None:
        check(state.get("kind") == "indexed_native",
              "incompatible indexed-native split state")
        self.close()
        reader = self._ensure_reader()
        epochs = int(state.get("epochs", 0))
        n = int(state["records"])
        reader.skip(epochs, n)
        self._cursor_clear()
        self._epochs = epochs
        self._records_out = n


def native_feed_recordio_eligible(uri: str, threaded: bool, *, index_uri=None,
                                  shuffle: bool = False, num_shuffle_parts: int = 0,
                                  cache_file=None) -> bool:
    """Whether ``create_input_split`` can route ``recordio`` on a
    non-local registered filesystem to :class:`NativeFeedRecordIOSplit`."""
    if not threaded or index_uri or shuffle or num_shuffle_parts or cache_file:
        return False
    if _is_local(uri) is not False:
        return False  # local corpora take the pull-mode reader
    return native.available()


class NativeFeedRecordIOSplit(NativeRecordIOSplit):
    """A corpus on a non-local filesystem through the native pipeline: a
    feed thread reads this partition's bytes through the filesystem layer
    (the Python splitter, which owns the byte range and its move to a
    record head) and pushes them into the native chunk feeder, which owns
    the record-aligned chunking, the framing scan and the multi-part
    reassembly. The reference wraps every source in its threaded decorator
    the same way (src/io.cc:119-124)."""

    FEED_CHUNK = 1 << 20

    def __init__(self, uri: str, part_index: int, num_parts: int,
                 recurse_directories: bool = False, chunk_bytes: int = DEFAULT_CHUNK_BYTES,
                 queue_depth: int = 4):
        _check_part(part_index, num_parts)
        self.uri = uri
        self.recurse_directories = recurse_directories
        self.part_index = part_index
        self.num_parts = num_parts
        self.chunk_bytes = chunk_bytes
        self.queue_depth = queue_depth
        self._mode: Optional[int] = None
        self._reader = None
        self._cursor_clear()
        self._feed_thread: Optional[threading.Thread] = None

    def _make_split(self) -> RecordIOSplitter:
        return RecordIOSplitter(self.uri, self.part_index, self.num_parts,
                                recurse_directories=self.recurse_directories)

    def _start_feed(self) -> None:
        feeder = self._reader
        split = self._make_split()

        def run() -> None:
            try:
                while True:
                    data = split._read(self.FEED_CHUNK)
                    if not data or not feeder.push(data):
                        break
                feeder.finish()
            except Exception as exc:  # noqa: BLE001
                # a failed read must not look like the end of the stream
                feeder.fail(f"feed failed: {exc}")
            finally:
                try:
                    split.close()
                except Exception:  # noqa: BLE001
                    pass

        self._feed_thread = threading.Thread(target=_telemetry.scoped_target(run),
                                             name="dmlc-rec-feed", daemon=True)
        self._feed_thread.start()

    def _stop_feed(self) -> None:
        if self._feed_thread is not None:
            if self._reader is not None:
                self._reader.abort()
            self._feed_thread.join()
            self._feed_thread = None

    def _ensure_reader(self, fmt: int):
        if self._reader is None:
            self._mode = fmt
            self._reader = native.Feeder(fmt, chunk_bytes=self.chunk_bytes,
                                         queue_depth=self.queue_depth)
            self._start_feed()
        elif self._mode != fmt:
            raise DMLCError("native recordio split: next_record and next_chunk cannot "
                            "be mixed within one epoch")
        return self._reader

    def before_first(self) -> None:
        if self._reader is not None:
            self._stop_feed()
            self._reader.before_first()
            self._start_feed()
        self._payload = self._offsets = None
        self._i = 0
        self._records_out = 0

    def close(self) -> None:
        self._stop_feed()
        super().close()
