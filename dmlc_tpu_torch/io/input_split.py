"""Partitioned, record-aware input splitting, and the split layer's factory.

Own copy of the JAX package's ``io/input_split.py`` (the behavioral
equivalent of reference src/io/input_split_base.{h,cc}, line_split.cc,
recordio_split.cc, indexed_recordio_split.cc, single_file_split.h,
threaded_input_split.h and input_split_shuffle.h):
:class:`InputSplitBase` with :class:`LineSplitter`, the zero-copy
:class:`MmapLineSplit`, :class:`RecordIOSplitter` and
:class:`IndexedRecordIOSplitter` under it; :class:`SingleFileSplit`
(stdin); the decorators :class:`ThreadedInputSplit` and
:class:`ShuffledInputSplit`; and :func:`create_input_split`, which also
selects the native RecordIO engines and, for a ``#cachefile`` URI, the
chunk cache (:mod:`dmlc_tpu_torch.io.cached_split`).

The partition invariant (input_split_base.cc:30-64, 196-199, 235-242):

- The logical dataset is the concatenation of all matched files.
- Partition ``k`` of ``n`` owns byte range ``[k*step, (k+1)*step)`` with
  ``step = align(ceil(total/n))``.
- Both range ends are advanced to the next record head by scanning from the
  raw byte offset (``seek_record_begin``) unless they sit exactly on a file
  boundary — file joins are implicit record boundaries.
- A '\\n' is injected at text-file joins so NOEOL files never merge records
  across files, and at end-of-partition when the final record lacks one.

Every record is therefore owned by exactly one partition: no loss, no
duplication. CRLF and blank lines pass through byte-identical; the
parsers treat '\\r' as a line end and skip blank lines.

The splitters take the partition at construction (``part_index=None``
leaves them unpartitioned until :meth:`InputSplitBase.reset_partition`,
as the JAX factory's are before it partitions them). Checkpoints:
:meth:`InputSplitBase.state_dict` is the JAX package's ``kind="byte"``
state key for key (the global offset, the file pointer, the undelivered
overflow and chunk tail in hex, the partition), and the indexed splitter's
is its ``kind="indexed"`` state, so a position taken in either package
seeks the other's splitter there.

Any registered filesystem serves (:mod:`dmlc_tpu_torch.io.filesystem`:
``file://``, ``mem://``); a splitter reads its files through the URI's
filesystem. The factory routes threaded, undecorated RecordIO splits to
the native engines (:mod:`dmlc_tpu_torch.io.native_recordio`) as the JAX
factory does.
"""

from __future__ import annotations

import mmap
import os
import random
import re
import struct
from bisect import bisect_right
from typing import BinaryIO, Iterator, List, Optional, Tuple

from dmlc_tpu_torch.io import recordio as rio
from dmlc_tpu_torch.io.filesystem import (DIR_TYPE, FileInfo, FileSystem, LocalFileSystem,
                                          get_filesystem)
from dmlc_tpu_torch.io.threaded_iter import ThreadedIter
from dmlc_tpu_torch.io.uri import URI, URISpec
from dmlc_tpu_torch.utils.check import DMLCError, check

_EOL = (0x0A, 0x0D)  # '\n', '\r'
DEFAULT_CHUNK_BYTES = 1 << 20


class InputSplit:
    """Abstract input split — analog of dmlc::InputSplit (io.h:190-242)."""

    def next_record(self) -> Optional[memoryview]:
        raise NotImplementedError

    def next_chunk(self) -> Optional[memoryview]:
        raise NotImplementedError

    def before_first(self) -> None:
        raise NotImplementedError

    def reset_partition(self, part_index: int, num_parts: int) -> None:
        raise NotImplementedError

    def hint_chunk_size(self, chunk_size: int) -> None:
        pass

    def close(self) -> None:
        pass

    def iter_records(self) -> Iterator[memoryview]:
        while True:
            rec = self.next_record()
            if rec is None:
                return
            yield rec

    def iter_chunks(self) -> Iterator[memoryview]:
        while True:
            chunk = self.next_chunk()
            if chunk is None:
                return
            yield chunk

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class _Chunk:
    """A loaded chunk being consumed record by record. ``raw`` is the
    backing bytes, so searches run at ``bytes.find`` speed; a full-span
    memoryview of bytes shares them, a partial view is copied once."""

    __slots__ = ("raw", "data", "pos", "resume_state")

    def __init__(self, data):
        if isinstance(data, memoryview):
            if isinstance(data.obj, bytes) and len(data) == len(data.obj):
                data = data.obj
            else:
                data = bytes(data)
        self.raw: bytes = data
        self.data = memoryview(data)
        self.pos = 0

    @property
    def exhausted(self) -> bool:
        return self.pos >= len(self.data)


def _match_files(fs: FileSystem, uri: str, recurse: bool) -> List[FileInfo]:
    """Expand ';'-separated URIs, directories (recursively with
    ``recurse``) and regex basename patterns over the parent directory
    (ConvertToURIs/InitInputFileInfo, input_split_base.cc:96-175), on the
    URI's filesystem ``fs``."""
    files: List[FileInfo] = []
    for part in uri.split(";"):
        if not part:
            continue
        path = URI(part)
        try:
            info = fs.get_path_info(path)
        except DMLCError:
            info = None
        if info is not None:
            if info.type == DIR_TYPE:
                listing = (fs.list_directory_recursive(info.path) if recurse
                           else fs.list_directory(info.path))
                files += [f for f in listing if f.type != DIR_TYPE and f.size > 0]
            elif info.size > 0:
                files.append(info)
            continue
        # regex match over the parent directory's entries
        pos = path.name.rstrip("/").rfind("/")
        if pos <= 0:
            continue
        pattern = re.compile(path.name)
        dir_uri = URI(path.protocol + path.host + path.name[:pos]
                      if path.protocol != "file://" else path.name[:pos])
        try:
            listing = fs.list_directory(dir_uri)
        except DMLCError:
            continue
        files += [f for f in listing if f.type != DIR_TYPE and f.size > 0
                  and pattern.fullmatch(f.path.name.rstrip("/"))]
    check(len(files) > 0, f"Cannot find any files that match the URI pattern {uri!r}")
    return files


class InputSplitBase(InputSplit):
    """The sharding engine — analog of InputSplitBase (input_split_base.cc).
    Subclasses define the record: :meth:`seek_record_begin`,
    :meth:`find_last_record_begin` and :meth:`extract_next_record`.

    The positions are the JAX package's (``dmlc_tpu/io/input_split.py:121``):
    ``fs`` is the filesystem that serves every part of ``uri`` (the
    factory passes ``get_filesystem(uri)``), and a split built without
    ``part_index`` holds no partition until :meth:`reset_partition`, as
    there. ``part_index`` / ``num_parts`` / ``chunk_bytes`` are keyword-only
    shortcuts for :meth:`reset_partition` and :meth:`hint_chunk_size`."""

    is_text = False
    align_bytes = 1

    def __init__(self, fs: FileSystem, uri: str, recurse_directories: bool = False, *,
                 part_index: Optional[int] = None, num_parts: int = 1,
                 chunk_bytes: int = DEFAULT_CHUNK_BYTES):
        self.fs = fs
        self.files = _match_files(self.fs, uri, recurse_directories)
        self.file_offset = [0]
        for info in self.files:
            check(info.size % self.align_bytes == 0,
                  f"file {info.path.name} does not align by {self.align_bytes} bytes")
            self.file_offset.append(self.file_offset[-1] + info.size)
        self.offset_begin = self.offset_end = self.offset_curr = 0
        self.file_ptr = 0
        self.part_index: Optional[int] = None
        self.num_parts: Optional[int] = None
        self._fp: Optional[BinaryIO] = None
        self._overflow = b""
        self._chunk: Optional[_Chunk] = None
        self._chunk_bytes = max(int(chunk_bytes), 4096)
        self.bytes_read = 0
        if part_index is not None:
            self.reset_partition(part_index, num_parts)

    # ---------------- subclass contract ----------------

    def seek_record_begin(self, stream: BinaryIO) -> int:
        """Bytes from the stream position to the next record head."""
        raise NotImplementedError

    def find_last_record_begin(self, data: bytes) -> int:
        """Offset of the last record head in ``data`` (0 = none found)."""
        raise NotImplementedError

    def extract_next_record(self, chunk: _Chunk) -> Optional[memoryview]:
        """Pop one record off the chunk; None when exhausted."""
        raise NotImplementedError

    # ---------------- partitioning ----------------

    def reset_partition(self, part_index: int, num_parts: int) -> None:
        """Byte-range partition + record-boundary adjustment
        (ResetPartition, input_split_base.cc:30-64)."""
        check(num_parts >= 1, f"num_parts must be >= 1, got {num_parts}")
        check(0 <= part_index < num_parts,
              f"part_index {part_index} out of range for {num_parts} parts")
        self.part_index, self.num_parts = part_index, num_parts
        ntotal = self.file_offset[-1]
        nstep = (ntotal + num_parts - 1) // num_parts
        align = self.align_bytes
        nstep = ((nstep + align - 1) // align) * align
        self.offset_begin = min(nstep * part_index, ntotal)
        self.offset_end = min(nstep * (part_index + 1), ntotal)
        self.offset_curr = self.offset_begin
        if self.offset_begin == self.offset_end:
            # an empty partition drops a previous partition's state too
            self._close_fp()
            self._overflow = b""
            self._chunk = None
            return
        file_ptr = bisect_right(self.file_offset, self.offset_begin) - 1
        file_ptr_end = bisect_right(self.file_offset, self.offset_end) - 1
        # adjust the end: extend to the next record head unless on a file join
        if self.offset_end != self.file_offset[file_ptr_end]:
            check(file_ptr_end < len(self.files), "partition end out of range")
            with self.fs.open_for_read(self.files[file_ptr_end].path) as f:
                f.seek(self.offset_end - self.file_offset[file_ptr_end])
                self.offset_end += self.seek_record_begin(f)
        # adjust the begin the same way
        self.file_ptr = file_ptr
        if self.offset_begin != self.file_offset[file_ptr]:
            with self.fs.open_for_read(self.files[file_ptr].path) as f:
                f.seek(self.offset_begin - self.file_offset[file_ptr])
                self.offset_begin += self.seek_record_begin(f)
        self.before_first()

    def before_first(self) -> None:
        """Seek back to the partition start (BeforeFirst, input_split_base.cc:66-82)."""
        if self.offset_begin >= self.offset_end:
            return
        self.file_ptr = bisect_right(self.file_offset, self.offset_begin) - 1
        self._close_fp()
        self._fp = self.fs.open_for_read(self.files[self.file_ptr].path)
        self._fp.seek(self.offset_begin - self.file_offset[self.file_ptr])
        self.offset_curr = self.offset_begin
        self._overflow = b""
        self._chunk = None

    # ---------------- reading ----------------

    def _read(self, size: int) -> bytes:
        """Read up to ``size`` payload bytes across file joins, injecting '\\n'
        at text-file joins (Read, input_split_base.cc:177-219)."""
        if self._fp is None or self.offset_begin >= self.offset_end:
            return b""
        size = min(size, self.offset_end - self.offset_curr)
        if size <= 0:
            return b""
        out = bytearray()
        nleft = size
        while nleft > 0:
            data = self._fp.read(nleft)
            if data:
                out += data
                nleft -= len(data)
                self.offset_curr += len(data)
                continue
            # file exhausted: newline injection at a text join (input_split_base.cc:196-199)
            if self.is_text:
                out += b"\n"
                nleft -= 1
            check(self.offset_curr == self.file_offset[self.file_ptr + 1],
                  "file offset not calculated correctly")
            if self.file_ptr + 1 >= len(self.files):
                break
            self.file_ptr += 1
            self._close_fp()
            self._fp = self.fs.open_for_read(self.files[self.file_ptr].path)
        self.bytes_read += len(out)
        return bytes(out)

    def read_chunk(self, max_size: int) -> Optional[bytes]:
        """One chunk of whole records; b'' means grow the buffer; None = EOF
        (ReadChunk, input_split_base.cc:221-258)."""
        if max_size <= len(self._overflow):
            return b""
        olen = len(self._overflow)
        data = self._overflow + self._read(max_size - olen)
        self._overflow = b""
        if len(data) == 0:
            return None
        if self.is_text:
            if len(data) == olen:
                # final record of the partition lacked a newline (input_split_base.cc:235-242)
                data += b"\n"
        elif len(data) != max_size:
            return data  # the EOF tail: its records are exactly complete
        cut = self.find_last_record_begin(data)
        self._overflow = data[cut:]
        return data[:cut]

    def _load_chunk(self) -> Optional[_Chunk]:
        """Grow-on-demand chunk load (Chunk::Load, input_split_base.cc:260-277)."""
        size = self._chunk_bytes
        while True:
            data = self.read_chunk(size)
            if data is None:
                return None
            if len(data) == 0:
                size *= 2
                continue
            return _Chunk(data)

    # ---------------- public iteration ----------------

    def next_record(self) -> Optional[memoryview]:
        while True:
            if self._chunk is not None:
                rec = self.extract_next_record(self._chunk)
                if rec is not None:
                    return rec
            self._chunk = self._load_chunk()
            if self._chunk is None:
                return None

    def next_chunk(self) -> Optional[memoryview]:
        """The next chunk of whole records, grown on demand for records
        longer than the chunk size; a pending record-iteration (or
        restored) tail first (ExtractNextChunk, input_split_base.cc:300-306);
        None at the end of the partition."""
        if self._chunk is not None and not self._chunk.exhausted:
            out = self._chunk.data[self._chunk.pos:]
            self._chunk = None
            return out
        chunk = self._load_chunk()
        if chunk is None:
            return None
        return chunk.data

    def hint_chunk_size(self, chunk_size: int) -> None:
        self._chunk_bytes = max(int(chunk_size), 4096)

    def records_in_chunk(self, chunk) -> Iterator[memoryview]:
        """The records inside a chunk already loaded (bytes or a view), in
        order (JAX's ``InputSplitBase.records_in_chunk``,
        ``dmlc_tpu/io/input_split.py:355``)."""
        c = _Chunk(chunk)
        while True:
            rec = self.extract_next_record(c)
            if rec is None:
                return
            yield rec

    # ---------------- checkpoint / resume ----------------

    @property
    def chunk_resume_state(self) -> Optional[dict]:
        """The position just after the chunk :meth:`next_chunk` last
        returned: on an undecorated split, the live state. Prefetching
        decorators return the state captured with the chunk instead."""
        return self.state_dict()

    def state_dict(self) -> dict:
        """Byte-exact resume point: the global offset and the undelivered
        buffer tails (the JAX package's ``kind="byte"`` state)."""
        pending = b""
        if self._chunk is not None and not self._chunk.exhausted:
            pending = bytes(self._chunk.data[self._chunk.pos:])
        return {
            "kind": "byte",
            "offset_curr": self.offset_curr,
            # tells a position on a file's end (its join '\n' not yet
            # injected) from the same offset at the next file's start
            "file_ptr": self.file_ptr,
            "overflow": self._overflow.hex(),
            "chunk": pending.hex(),
            "part_index": self.part_index,
            "num_parts": self.num_parts,
        }

    def load_state(self, state: dict) -> None:
        """Seek to a :meth:`state_dict` position (the same URI; the
        recorded partition is re-applied when it differs)."""
        check(state.get("kind") == "byte", "incompatible split state")
        part, nparts = state.get("part_index"), state.get("num_parts")
        if (part is not None and nparts is not None
                and (part, nparts) != (self.part_index, self.num_parts)):
            self.reset_partition(int(part), int(nparts))
        off = int(state["offset_curr"])
        check(self.offset_begin <= off <= self.offset_end,
              f"state offset {off} outside partition "
              f"[{self.offset_begin}, {self.offset_end})")
        self._close_fp()
        self.offset_curr = off
        file_ptr = int(state.get("file_ptr", -1))
        if not (0 <= file_ptr < len(self.files)
                and self.file_offset[file_ptr] <= off <= self.file_offset[file_ptr + 1]):
            file_ptr = min(bisect_right(self.file_offset, off) - 1, len(self.files) - 1)
        self.file_ptr = file_ptr
        if off < self.file_offset[-1] or off == self.file_offset[file_ptr + 1]:
            # reopen the recorded file even when off sits on its end: the
            # next _read then injects the pending join newline
            self._fp = self.fs.open_for_read(self.files[file_ptr].path)
            self._fp.seek(off - self.file_offset[file_ptr])
        self._overflow = bytes.fromhex(state["overflow"])
        pending = bytes.fromhex(state["chunk"])
        self._chunk = _Chunk(pending) if pending else None

    def _close_fp(self) -> None:
        if self._fp is not None:
            self._fp.close()
            self._fp = None

    def close(self) -> None:
        self._close_fp()


class LineSplitter(InputSplitBase):
    """Record = line — analog of src/io/line_split.cc. '\\n' and '\\r' both
    terminate, runs of EOL bytes collapse (blank lines give no records),
    and records exclude the terminator."""

    is_text = True
    align_bytes = 1

    def seek_record_begin(self, stream: BinaryIO) -> int:
        """Scan to the first EOL, then past the EOL run (line_split.cc:9-26)."""
        nstep = 0
        found = False
        rest = b""
        while not found:
            block = stream.read(512)
            if not block:
                return nstep
            for i, b in enumerate(block):
                nstep += 1
                if b in _EOL:
                    found = True
                    rest = block[i + 1:]
                    break
        while True:
            for b in rest:
                if b in _EOL:
                    nstep += 1
                else:
                    return nstep
            rest = stream.read(512)
            if not rest:
                return nstep

    def find_last_record_begin(self, data: bytes) -> int:
        """Position after the last EOL (line_split.cc:27-34); 0 if none."""
        pos = max(data.rfind(b"\n"), data.rfind(b"\r"))
        return pos + 1 if pos >= 0 else 0

    def extract_next_record(self, chunk: _Chunk) -> Optional[memoryview]:
        data, pos, end = chunk.data, chunk.pos, len(chunk.data)
        # skip a leading EOL run (blank lines collapse, line_split.cc:36-55)
        while pos < end and data[pos] in _EOL:
            pos += 1
        if pos >= end:
            chunk.pos = end
            return None
        nl = _find_eol(chunk.raw, pos)
        rec = data[pos:nl]
        pos = nl
        while pos < end and data[pos] in _EOL:
            pos += 1
        chunk.pos = pos
        return rec


def _find_eol(raw: bytes, start: int) -> int:
    nl = raw.find(b"\n", start)
    end = nl if nl >= 0 else len(raw)
    # the \r search stops at the \n: a \r-free chunk is not rescanned
    cr = raw.find(b"\r", start, end)
    return cr if cr >= 0 else end


class MmapLineSplit(LineSplitter):
    """Zero-copy chunk reads over local text files.

    Chunks are memoryview slices of per-file mmaps, cut at the last record
    boundary inside the chunk budget: each pull costs a tail ``rfind``
    instead of the stream's read, concat and slice over every byte. It is
    the serial chunk source under the parse fan-out
    (:class:`dmlc_tpu_torch.data.parsers.ParallelTextParser`), which needs
    a pull far cheaper than its workers' parse.

    The partition bounds are :class:`LineSplitter`'s, byte for byte. A
    chunk never spans a file join (ending it at the file's end is the same
    record boundary as the stream's injected newline), so on a single file
    the chunks hold the stream's records with the stream's grouping; an
    unterminated last line is a chunk of its own, as there. States keep the
    ``kind="byte"`` schema with ``offset_curr`` counting file bytes (no
    overflow is ever held), so they restore across the two splits and the
    two packages; a state with a pending chunk tail (a record iteration's,
    which no chunk-pulling parser produces) is refused.
    """

    def __init__(self, fs: FileSystem, uri: str, recurse_directories: bool = False, *,
                 part_index: Optional[int] = None, num_parts: int = 1,
                 chunk_bytes: int = DEFAULT_CHUNK_BYTES):
        check(isinstance(fs, LocalFileSystem), "MmapLineSplit requires local files")
        self._maps: List[Optional[mmap.mmap]] = []
        self._views: List[Optional[memoryview]] = []
        super().__init__(fs, uri, recurse_directories, part_index=part_index,
                         num_parts=num_parts, chunk_bytes=chunk_bytes)
        self._maps = [None] * len(self.files)
        self._views = [None] * len(self.files)

    def _map(self, fi: int):
        """The lazily mapped file ``fi``; the listing's size is the truth, so
        a file that shrank since fails loudly instead of faulting."""
        if self._maps[fi] is None:
            name = self.files[fi].path.name
            with open(name, "rb") as f:
                size = os.fstat(f.fileno()).st_size
                check(size >= self.files[fi].size,
                      f"{name}: shrank since listing ({size} < {self.files[fi].size} bytes)")
                self._maps[fi] = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
            self._views[fi] = memoryview(self._maps[fi])
        return self._maps[fi], self._views[fi]

    def next_chunk(self) -> Optional[memoryview]:
        # a pending record-iteration tail first (the base-class contract)
        if self._chunk is not None and not self._chunk.exhausted:
            out = self._chunk.data[self._chunk.pos:]
            self._chunk = None
            return out
        self._chunk = None
        # a partition emptied by the record-boundary adjustment yields nothing
        if self.offset_begin >= self.offset_end or self.offset_curr >= self.offset_end:
            return None
        pos = max(self.offset_curr, self.offset_begin)
        fi = min(bisect_right(self.file_offset, pos) - 1, len(self.files) - 1)
        self.file_ptr = fi
        fbase = self.file_offset[fi]
        hard_end = min(self.offset_end, self.file_offset[fi + 1]) - fbase
        lo = pos - fbase
        mm, mv = self._map(fi)
        size = self._chunk_bytes
        while True:
            hi = lo + size
            if hi >= hard_end:
                # the partition's or file's end; an unterminated last line
                # is its own chunk, as the stream cuts it
                eol = max(mm.rfind(b"\n", lo, hard_end), mm.rfind(b"\r", lo, hard_end))
                cut = eol + 1 if lo <= eol and eol + 1 < hard_end else hard_end
                break
            eol = max(mm.rfind(b"\n", lo, hi), mm.rfind(b"\r", lo, hi))
            if eol >= lo:
                cut = eol + 1
                break
            size *= 2  # grow until a whole record fits (Chunk::Load)
        self.offset_curr = fbase + cut
        self.bytes_read += cut - lo
        return mv[lo:cut]

    def next_record(self) -> Optional[memoryview]:
        while True:
            if self._chunk is not None:
                rec = self.extract_next_record(self._chunk)
                if rec is not None:
                    return rec
            nxt = self.next_chunk()
            if nxt is None:
                self._chunk = None
                return None
            self._chunk = _Chunk(nxt)

    def before_first(self) -> None:
        # rewinding an empty partition is safe here (no file handle), and
        # offset_curr must never keep reset_partition's raw position
        self.offset_curr = self.offset_begin
        self.file_ptr = min(max(bisect_right(self.file_offset, self.offset_begin) - 1, 0),
                            len(self.files) - 1)
        self._overflow = b""
        self._chunk = None

    def load_state(self, state: dict) -> None:
        check(state.get("kind") == "byte", "incompatible split state")
        part, nparts = state.get("part_index"), state.get("num_parts")
        if (part is not None and nparts is not None
                and (part, nparts) != (self.part_index, self.num_parts)):
            self.reset_partition(int(part), int(nparts))
        check(not state.get("chunk"),
              "MmapLineSplit cannot restore a mid-record-iteration state "
              "with a pending chunk tail (chunk-pulling consumers never "
              "produce one)")
        # a stream state counts its read-ahead overflow in offset_curr; the
        # overflow never holds a join newline, so this is file-byte exact
        off = int(state["offset_curr"]) - len(bytes.fromhex(state.get("overflow", "") or ""))
        check(self.offset_begin <= off <= self.offset_end,
              f"state offset {off} outside partition "
              f"[{self.offset_begin}, {self.offset_end})")
        self.offset_curr = off
        self.file_ptr = min(bisect_right(self.file_offset, off) - 1, len(self.files) - 1)
        self._overflow = b""
        self._chunk = None

    def close(self) -> None:
        self._chunk = None
        for i, mm in enumerate(self._maps):
            if mm is None:
                continue
            view, self._views[i], self._maps[i] = self._views[i], None, None
            try:
                view.release()
                mm.close()
            except BufferError:
                pass  # chunk views still alive: the garbage collector unmaps
        super().close()


def create_mmap_text_split(uri: str, part_index: int, num_parts: int,
                           chunk_bytes: int = DEFAULT_CHUNK_BYTES,
                           recurse_directories: bool = False) -> MmapLineSplit:
    """The zero-copy local text chunk source (the JAX package's factory of
    the same name and positions, ``dmlc_tpu/io/input_split.py:684``; a URI
    that is not plain local files raises ``DMLCError``)."""
    check(num_parts >= 1, f"num_parts must be >= 1, got {num_parts}")
    check(0 <= part_index < num_parts,
          f"part_index {part_index} out of range for {num_parts} parts")
    return MmapLineSplit(get_filesystem(uri), uri, recurse_directories,
                         part_index=part_index, num_parts=num_parts, chunk_bytes=chunk_bytes)


class RecordIOSplitter(InputSplitBase):
    """Record = RecordIO frame — analog of src/io/recordio_split.cc."""

    is_text = False
    align_bytes = 4

    def seek_record_begin(self, stream: BinaryIO) -> int:
        """Scan 4-byte cells for a head (magic + cflag 0|1)
        (recordio_split.cc:9-25)."""
        nstep = 0
        while True:
            cell = stream.read(4)
            if len(cell) < 4:
                return nstep
            nstep += 4
            if struct.unpack("<I", cell)[0] == rio.RECORDIO_MAGIC:
                lrec_raw = stream.read(4)
                check(len(lrec_raw) == 4, "invalid recordio format")
                nstep += 4
                lrec = struct.unpack("<I", lrec_raw)[0]
                if rio.decode_flag(lrec) in (0, 1):
                    return nstep - 8

    def find_last_record_begin(self, data: bytes) -> int:
        heads = rio.find_record_heads(data)
        return int(heads[-1]) if len(heads) else 0

    def extract_next_record(self, chunk: _Chunk) -> Optional[memoryview]:
        if chunk.exhausted:
            return None
        rec, chunk.pos = rio.extract_record(chunk.data, chunk.pos, len(chunk.data))
        return rec


class SingleFileSplit(InputSplit):
    """Line reading of a single file or stdin, no partitioning
    (src/io/single_file_split.h), in bounded record-aligned chunks, so a
    large file or a stdin feed costs O(chunk_bytes) memory. stdin is
    single-pass: a second epoch raises instead of replaying partial data."""

    def __init__(self, path: str, chunk_bytes: int = 4 << 20):
        self.path = path
        self.chunk_bytes = max(4096, int(chunk_bytes))
        self._fp = None
        self._overflow = b""
        self._eof = True
        self._started = False
        self._stdin_consumed = False
        self._records: Iterator[memoryview] = iter(())

    def reset_partition(self, part_index: int, num_parts: int) -> None:
        check(part_index == 0 and num_parts == 1,
              "SingleFileSplit does not support partitioning")
        self.before_first()

    def before_first(self) -> None:
        if self.path == "stdin":
            import sys

            check(not self._stdin_consumed,
                  "SingleFileSplit: stdin is single-pass and cannot restart")
            self._fp = sys.stdin.buffer
        else:
            if self._fp is not None:
                self._fp.close()
            path = URI(self.path)
            self._fp = get_filesystem(path).open_for_read(path)
        self._overflow = b""
        self._eof = False
        self._started = True
        self._records = iter(())

    def _read_chunk(self) -> Optional[bytes]:
        """Next record-aligned chunk of ~chunk_bytes, or None at EOF."""
        if self._eof and not self._overflow:
            return None
        parts = [self._overflow]
        got = len(self._overflow)
        self._overflow = b""
        target = self.chunk_bytes
        while True:
            while got < target and not self._eof:
                data = self._fp.read(target - got)
                if not data:
                    self._eof = True
                    break
                if self.path == "stdin":
                    self._stdin_consumed = True
                parts.append(data)
                got += len(data)
            data = b"".join(parts)
            if self._eof:
                return data if data else None
            # cut after the last EOL so the chunk holds whole records
            cut = max(data.rfind(b"\n"), data.rfind(b"\r")) + 1
            if cut > 0:
                self._overflow = data[cut:]
                return data[:cut]
            # a single record longer than the chunk: keep growing
            parts = [data]
            target *= 2

    def next_record(self) -> Optional[memoryview]:
        if not self._started:
            self.before_first()
        rec = next(self._records, None)
        while rec is None:
            chunk = self._read_chunk()
            if chunk is None:
                return None
            mv = memoryview(chunk)
            self._records = iter([mv[s:e] for s, e in _line_spans(chunk)])
            rec = next(self._records, None)
        return rec

    def next_chunk(self) -> Optional[memoryview]:
        """Successive record-aligned chunks, sharing the stream with
        ``next_record``: records already materialized from a partly
        consumed chunk are dropped for the next chunk of the stream."""
        if not self._started:
            self.before_first()
        self._records = iter(())
        chunk = self._read_chunk()
        return memoryview(chunk) if chunk is not None else None

    def close(self) -> None:
        if self._fp is not None and self.path != "stdin":
            self._fp.close()
            self._fp = None


def _line_spans(data: bytes) -> List[Tuple[int, int]]:
    spans = []
    pos, n = 0, len(data)
    while pos < n:
        while pos < n and data[pos] in _EOL:
            pos += 1
        if pos >= n:
            break
        end = data.find(b"\n", pos)
        cr = data.find(b"\r", pos)
        if end < 0 or (0 <= cr < end):
            end = cr
        if end < 0:
            end = n
        spans.append((pos, end))
        pos = end
    return spans


class IndexedRecordIOSplitter(InputSplitBase):
    """Record-count partitioning with an external index + optional shuffle —
    analog of src/io/indexed_recordio_split.cc."""

    is_text = False
    align_bytes = 4
    # the state carries the epoch permutation and rng state: far too heavy
    # to capture with every prefetched chunk (ThreadedInputSplit._produce)
    cheap_chunk_state = False

    def __init__(self, fs: FileSystem, uri: str, index_uri: str, batch_size: int = 256,
                 shuffle: bool = False, seed: int = 0, *, part_index: Optional[int] = None,
                 num_parts: int = 1, chunk_bytes: int = DEFAULT_CHUNK_BYTES):
        super().__init__(fs, uri, chunk_bytes=chunk_bytes)
        index = URI(index_uri)
        with get_filesystem(index).open_for_read(index) as f:
            self.index = rio.read_index_file(f, self.file_offset[-1])
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = random.Random(seed)
        self.index_begin = self.index_end = self.current_index = 0
        self.permutation: List[int] = []
        if part_index is not None:
            self.reset_partition(part_index, num_parts)

    seek_record_begin = RecordIOSplitter.seek_record_begin
    find_last_record_begin = RecordIOSplitter.find_last_record_begin
    extract_next_record = RecordIOSplitter.extract_next_record

    def reset_partition(self, part_index: int, num_parts: int) -> None:
        """Partition by record count (indexed_recordio_split.cc:12-41)."""
        check(num_parts >= 1, f"num_parts must be >= 1, got {num_parts}")
        check(0 <= part_index < num_parts,
              f"part_index {part_index} out of range for {num_parts} parts")
        self.part_index, self.num_parts = part_index, num_parts
        ntotal = len(self.index)
        nstep = (ntotal + num_parts - 1) // num_parts
        if part_index * nstep >= ntotal:
            # an empty partition clears a previous partition's state
            self.offset_begin = self.offset_end = 0
            self.index_begin = self.index_end = 0
            self.current_index = 0
            self.permutation = []
            self._overflow = b""
            self._chunk = None
            self._close_fp()
            return
        self.index_begin = part_index * nstep
        self.offset_begin = self.index[self.index_begin][0]
        if (part_index + 1) * nstep < ntotal:
            self.index_end = (part_index + 1) * nstep
            self.offset_end = self.index[self.index_end][0]
        else:
            self.index_end = ntotal
            self.offset_end = self.file_offset[-1]
        self.before_first()

    def before_first(self) -> None:
        if self.shuffle:
            self.permutation = list(range(self.index_begin, self.index_end))
            self.rng.shuffle(self.permutation)
            self.current_index = 0
        else:
            self.current_index = self.index_begin
        super().before_first()

    # -------- checkpoint / resume --------
    #
    # reads are index-driven (offset_curr never advances), so the state is
    # the record cursor and, under shuffle, the permutation + rng state

    def state_dict(self) -> dict:
        pending = b""
        if self._chunk is not None and not self._chunk.exhausted:
            pending = bytes(self._chunk.data[self._chunk.pos:])
        st = {
            "kind": "indexed",
            "current_index": self.current_index,
            "chunk": pending.hex(),
            "part_index": self.part_index,
            "num_parts": self.num_parts,
        }
        if self.shuffle:
            st["permutation"] = list(self.permutation)
            rs = self.rng.getstate()
            st["rng_state"] = [rs[0], list(rs[1]), rs[2]]
        return st

    def load_state(self, state: dict) -> None:
        check(state.get("kind") == "indexed", "incompatible indexed-recordio split state")
        part, nparts = state.get("part_index"), state.get("num_parts")
        if (part is not None and nparts is not None
                and (part, nparts) != (self.part_index, self.num_parts)):
            self.reset_partition(int(part), int(nparts))
        self._close_fp()
        self._overflow = b""
        if self.shuffle:
            self.permutation = list(state["permutation"])
            r0, r1, r2 = state["rng_state"]
            self.rng.setstate((r0, tuple(r1), r2))
        self.current_index = int(state["current_index"])
        pending = bytes.fromhex(state["chunk"])
        self._chunk = _Chunk(pending) if pending else None

    def _next_batch_data(self, n_records: int) -> Optional[bytes]:
        """The next ``n_records`` as one contiguous buffer
        (NextBatchEx, indexed_recordio_split.cc:159-212)."""
        if self.shuffle:
            parts: List[bytes] = []
            taken = 0
            while taken < n_records and self.current_index < len(self.permutation):
                offset, size = self.index[self.permutation[self.current_index]]
                parts.append(self._read_span(offset, size))
                self.current_index += 1
                taken += 1
            if not parts:
                return None
            return b"".join(parts)
        if self.current_index >= self.index_end:
            return None
        last = min(self.current_index + n_records, self.index_end)
        begin_off = self.index[self.current_index][0]
        end_off = self.index[last][0] if last < len(self.index) else self.file_offset[-1]
        if last == self.index_end:
            end_off = self.offset_end
        data = self._read_span(begin_off, end_off - begin_off)
        self.current_index = last
        return data

    def _read_span(self, offset: int, size: int) -> bytes:
        """Read an absolute ``[offset, offset + size)`` span across files."""
        out = bytearray()
        while size > 0:
            fidx = bisect_right(self.file_offset, offset) - 1
            if fidx >= len(self.files):
                break
            if self.file_ptr != fidx or self._fp is None:
                self._close_fp()
                self.file_ptr = fidx
                self._fp = self.fs.open_for_read(self.files[fidx].path)
            self._fp.seek(offset - self.file_offset[fidx])
            data = self._fp.read(min(size, self.file_offset[fidx + 1] - offset))
            if not data:
                break
            out += data
            offset += len(data)
            size -= len(data)
        self.bytes_read += len(out)
        return bytes(out)

    def next_chunk(self) -> Optional[memoryview]:
        return self.next_batch(self.batch_size)

    def next_batch(self, n_records: int) -> Optional[memoryview]:
        data = self._next_batch_data(n_records)
        return memoryview(data) if data is not None else None

    def next_record(self) -> Optional[memoryview]:
        while True:
            if self._chunk is not None:
                rec = self.extract_next_record(self._chunk)
                if rec is not None:
                    return rec
            data = self._next_batch_data(self.batch_size)
            if data is None:
                self._chunk = None
                return None
            self._chunk = _Chunk(data)


class ThreadedInputSplit(InputSplit):
    """Prefetch decorator: a producer thread loads chunks ahead
    (src/io/threaded_input_split.h; capacity 2 as there, :33-42). Each
    chunk carries the base's position captured when it was produced, so
    :attr:`chunk_resume_state` is the position just after the chunk handed
    out last, not the prefetched live one; a splitter whose state is heavy
    opts out with ``cheap_chunk_state = False`` (consumers then resume by
    a chunk count)."""

    def __init__(self, base: InputSplitBase, capacity: int = 2):
        self.base = base
        self._capacity = capacity
        self._iter = ThreadedIter(self._produce, self._reset_base, max_capacity=capacity)
        self._chunk: Optional[_Chunk] = None
        self._last_chunk_state: Optional[dict] = None

    def _produce(self, cell):
        chunk = self.base.next_chunk()
        if chunk is None:
            return False, None
        out = _Chunk(chunk)
        out.resume_state = None
        if getattr(self.base, "cheap_chunk_state", True):
            try:
                out.resume_state = self.base.state_dict()
            except (AttributeError, DMLCError):
                pass
        return True, out

    def _reset_base(self):
        self.base.before_first()

    def _restart(self) -> None:
        self._iter = ThreadedIter(self._produce, self._reset_base, max_capacity=self._capacity)
        self._chunk = None

    def next_chunk(self) -> Optional[memoryview]:
        chunk = self._iter.next()
        if chunk is None:
            return None
        self._last_chunk_state = chunk.resume_state
        return chunk.data

    @property
    def chunk_resume_state(self) -> Optional[dict]:
        """The base's state as of the chunk handed out last."""
        return self._last_chunk_state

    def next_record(self) -> Optional[memoryview]:
        while True:
            if self._chunk is not None:
                rec = self.base.extract_next_record(self._chunk)
                if rec is not None:
                    return rec
            self._chunk = self._iter.next()
            if self._chunk is None:
                return None

    def before_first(self) -> None:
        self._iter.before_first()
        self._chunk = None
        self._last_chunk_state = None  # else a stale end-of-epoch position

    def reset_partition(self, part_index: int, num_parts: int) -> None:
        # quiesce the producer, repartition the base, restart
        self._iter.destroy()
        self.base.reset_partition(part_index, num_parts)
        self._restart()
        self._last_chunk_state = None

    def load_state(self, state: dict) -> None:
        """Seek the base to a saved position (a :attr:`chunk_resume_state`
        or the base's ``state_dict``) and restart the prefetch there: the
        producer never re-reads the consumed prefix."""
        self._iter.destroy()
        self.base.load_state(state)
        self._restart()
        self._last_chunk_state = state

    def hint_chunk_size(self, chunk_size: int) -> None:
        self.base.hint_chunk_size(chunk_size)

    def close(self) -> None:
        self._iter.destroy()
        self.base.close()

    @property
    def stall_seconds(self) -> float:
        return self._iter.stall_seconds


class ShuffledInputSplit(InputSplit):
    """Chunk-level shuffle — analog of include/dmlc/input_split_shuffle.h.

    Splits this rank's partition into ``num_shuffle_parts`` sub-partitions
    and visits them in a ``random.Random(seed)`` order each epoch
    (input_split_shuffle.h:19-60). With a block cache,
    :func:`~dmlc_tpu_torch.data.parsers.create_parser` maps the legacy
    ``shuffle`` / ``num_shuffle_parts`` arguments onto the epoch plan
    instead (with a ``DeprecationWarning``); uncached parsing uses this
    decorator.
    """

    def __init__(self, make_base, part_index: int, num_parts: int,
                 num_shuffle_parts: int, seed: int = 0):
        check(num_shuffle_parts > 0, "num_shuffle_parts must be positive")
        self._make_base = make_base
        self.base: InputSplit = make_base()
        self.part_index = part_index
        self.num_parts = num_parts
        self.num_shuffle_parts = num_shuffle_parts
        self.rng = random.Random(seed)
        self._order: List[int] = []
        self._order_pos = 0
        self._active = False
        self.before_first()

    def _sub_parts(self) -> List[int]:
        base = self.part_index * self.num_shuffle_parts
        return [base + i for i in range(self.num_shuffle_parts)]

    def before_first(self) -> None:
        self._order = self._sub_parts()
        self.rng.shuffle(self._order)
        self._order_pos = 0
        self._active = False

    def reset_partition(self, part_index: int, num_parts: int) -> None:
        self.part_index = part_index
        self.num_parts = num_parts
        self.before_first()

    def _advance(self) -> bool:
        if self._order_pos >= len(self._order):
            return False
        sub = self._order[self._order_pos]
        self._order_pos += 1
        self.base.reset_partition(sub, self.num_parts * self.num_shuffle_parts)
        self._active = True
        return True

    def next_record(self) -> Optional[memoryview]:
        while True:
            if self._active:
                rec = self.base.next_record()
                if rec is not None:
                    return rec
                self._active = False
            if not self._advance():
                return None

    def next_chunk(self) -> Optional[memoryview]:
        while True:
            if self._active:
                chunk = self.base.next_chunk()
                if chunk is not None:
                    return chunk
                self._active = False
            if not self._advance():
                return None

    def hint_chunk_size(self, chunk_size: int) -> None:
        self.base.hint_chunk_size(chunk_size)

    def close(self) -> None:
        self.base.close()


def _native_split(spec: URISpec, part_index: int, num_parts: int, type_: str,
                  index_uri: Optional[str], shuffle: bool, seed: int, batch_size: int,
                  threaded: bool, recurse_directories: bool, num_shuffle_parts: int,
                  chunk_bytes: int) -> Optional[InputSplit]:
    """The JAX factory's native RecordIO routes
    (:mod:`dmlc_tpu_torch.io.native_recordio`), or None for the Python
    splitters: ``recordio`` on a local corpus takes
    :class:`NativeRecordIOSplit`, on another registered filesystem
    :class:`NativeFeedRecordIOSplit`; ``indexed_recordio`` on a local corpus
    and index takes :class:`NativeIndexedRecordIOSplit`. An engine that
    raises at construction falls through to the Python splitter, as in the
    JAX package."""
    from dmlc_tpu_torch.io import native_recordio as nr

    uri, cache_file = spec.uri, spec.cache_file
    if not nr.native_engine_enabled(spec.args):
        return None
    try:
        if type_ == "recordio":
            if nr.native_recordio_eligible(
                    uri, threaded, index_uri=index_uri, shuffle=shuffle,
                    num_shuffle_parts=num_shuffle_parts, cache_file=cache_file,
                    recurse_directories=recurse_directories):
                return nr.NativeRecordIOSplit(uri, part_index, num_parts,
                                              recurse_directories=recurse_directories,
                                              chunk_bytes=chunk_bytes)
            if nr.native_feed_recordio_eligible(
                    uri, threaded, index_uri=index_uri, shuffle=shuffle,
                    num_shuffle_parts=num_shuffle_parts, cache_file=cache_file):
                return nr.NativeFeedRecordIOSplit(uri, part_index, num_parts,
                                                  recurse_directories=recurse_directories,
                                                  chunk_bytes=chunk_bytes)
        elif (type_ == "indexed_recordio" and index_uri is not None
              and nr.native_indexed_eligible(uri, index_uri, threaded,
                                             num_shuffle_parts=num_shuffle_parts,
                                             cache_file=cache_file)):
            return nr.NativeIndexedRecordIOSplit(uri, index_uri, part_index, num_parts,
                                                 batch_size=batch_size, shuffle=shuffle,
                                                 seed=seed,
                                                 recurse_directories=recurse_directories)
    except DMLCError:
        pass  # the Python splitter serves it
    return None


def create_input_split(
    uri: str,
    part_index: int,
    num_parts: int,
    type_: str = "text",
    *,
    index_uri: Optional[str] = None,
    shuffle: bool = False,
    seed: int = 0,
    batch_size: int = 256,
    threaded: bool = True,
    recurse_directories: bool = False,
    num_shuffle_parts: int = 0,
    chunk_bytes: int = DEFAULT_CHUNK_BYTES,
) -> InputSplit:
    """Factory — analog of InputSplit::Create (src/io.cc:74-130), with the
    JAX package's signature.

    ``type_``: ``text`` (alias ``line``), ``recordio``,
    ``indexed_recordio`` (needs ``index_uri``; ``batch_size`` records a
    chunk, ``shuffle`` / ``seed`` a per-epoch permutation) or ``stdin``.
    A threaded, undecorated ``recordio`` or ``indexed_recordio`` split
    takes the native RecordIO engines where the JAX factory does
    (:func:`_native_split`; ``?engine=python`` or
    ``DMLC_TPU_NO_NATIVE_READER`` keeps the Python splitters). Otherwise
    wraps the splitter in a prefetch thread by default (src/io.cc:119-124),
    in the chunk-shuffle decorator when ``num_shuffle_parts > 0``
    (input_split_shuffle.h's InputSplit::Create overload), and in the
    chunk cache for a ``real#cachefile`` URI, whose partition-qualified
    name comes from :class:`~dmlc_tpu_torch.io.uri.URISpec`
    (src/io.cc:81-88, 119-123).
    """
    check(num_parts >= 1, f"num_parts must be >= 1, got {num_parts}")
    check(0 <= part_index < num_parts,
          f"part_index {part_index} out of range for {num_parts} parts")
    if uri == "stdin" or type_ == "stdin":
        return SingleFileSplit(uri)
    spec = URISpec(uri, part_index, num_parts)
    uri = spec.uri
    cache_file = spec.cache_file
    native_split = _native_split(spec, part_index, num_parts, type_, index_uri, shuffle, seed,
                                 batch_size, threaded, recurse_directories, num_shuffle_parts,
                                 chunk_bytes)
    if native_split is not None:
        return native_split

    def make_raw(part: Optional[int] = None) -> InputSplitBase:
        """The splitter, partitioned when ``part`` is given."""
        fs = get_filesystem(uri)
        if type_ in ("text", "line"):
            return LineSplitter(fs, uri, recurse_directories, part_index=part,
                                num_parts=num_parts, chunk_bytes=chunk_bytes)
        if type_ == "recordio":
            return RecordIOSplitter(fs, uri, recurse_directories, part_index=part,
                                    num_parts=num_parts, chunk_bytes=chunk_bytes)
        if type_ == "indexed_recordio":
            check(index_uri is not None, "indexed_recordio requires index_uri")
            return IndexedRecordIOSplitter(fs, uri, index_uri, batch_size, shuffle, seed,
                                           part_index=part, num_parts=num_parts,
                                           chunk_bytes=chunk_bytes)
        raise DMLCError(f"unknown input split type {type_!r}")

    if num_shuffle_parts > 0:
        check(cache_file is None, "cachefile and num_shuffle_parts cannot be combined")

        def make_base() -> InputSplit:
            base: InputSplit = make_raw()
            return ThreadedInputSplit(base) if threaded else base

        return ShuffledInputSplit(make_base, part_index, num_parts, num_shuffle_parts,
                                  seed=seed)
    if cache_file is not None:
        from dmlc_tpu_torch.io.cached_split import CachedInputSplit

        cls = {"text": LineSplitter, "line": LineSplitter,
               "recordio": RecordIOSplitter}.get(type_)
        check(cls is not None, f"cachefile not supported for type {type_!r}")
        return CachedInputSplit(lambda: make_raw(part_index), cache_file, splitter_cls=cls)
    base = make_raw(part_index)
    return ThreadedInputSplit(base) if threaded else base
