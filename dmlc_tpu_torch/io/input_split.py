"""Partitioned, line-aware input splitting — ``LineSplitter`` and
``MmapLineSplit``.

Own copy of the JAX package's ``io/input_split.py`` (InputSplitBase +
LineSplitter, MmapLineSplit), trimmed to what the port's parse path uses:
byte-range partitioning of local text files and whole-record chunk reads,
by a stream of reads or as zero-copy slices of an mmap.

The partition invariant (input_split_base.cc:30-64, 196-199, 235-242):

- The logical dataset is the concatenation of all matched files.
- Partition ``k`` of ``n`` owns byte range ``[k*step, (k+1)*step)`` with
  ``step = ceil(total/n)``.
- Both range ends are advanced to the next record head by scanning from the
  raw byte offset (``seek_record_begin``) unless they sit exactly on a file
  boundary — file joins are implicit record boundaries.
- A '\\n' is injected at file joins so NOEOL files never merge records
  across files, and at end-of-partition when the final record lacks one.

Every line is therefore owned by exactly one partition: no loss, no
duplication. CRLF and blank lines pass through byte-identical; the
parsers treat '\\r' as a line end and skip blank lines.

Checkpoints: :meth:`LineSplitter.state_dict` is the JAX package's
``kind="byte"`` state key for key (the global offset, the file pointer,
the undelivered overflow and chunk tail in hex, the partition), so a
position taken in either package seeks the other's splitter there.
"""

from __future__ import annotations

import mmap
import os
from bisect import bisect_right
from typing import BinaryIO, List, Optional

from dmlc_tpu_torch.io.filesystem import DIR_TYPE, FileInfo, get_filesystem
from dmlc_tpu_torch.io.uri import URI
from dmlc_tpu_torch.utils.check import check

_EOL = (0x0A, 0x0D)  # '\n', '\r'
DEFAULT_CHUNK_BYTES = 1 << 20


class LineSplitter:
    """Record = line — analog of src/io/line_split.cc over
    InputSplitBase (input_split_base.cc)."""

    def __init__(self, uri: str, part_index: int = 0, num_parts: int = 1,
                 chunk_bytes: int = DEFAULT_CHUNK_BYTES):
        self.files: List[FileInfo] = []
        for part in uri.split(";"):
            if not part:
                continue
            path = URI(part)
            fs = get_filesystem(path)
            info = fs.get_path_info(path)
            listing = fs.list_directory(info.path) if info.type == DIR_TYPE else [info]
            self.files += [f for f in listing if f.type != DIR_TYPE and f.size > 0]
        check(len(self.files) > 0, f"Cannot find any files that match the URI pattern {uri!r}")
        self.fs = get_filesystem(self.files[0].path)
        self.file_offset = [0]
        for info in self.files:
            self.file_offset.append(self.file_offset[-1] + info.size)
        self.offset_begin = self.offset_end = self.offset_curr = 0
        self.file_ptr = 0
        self._fp: Optional[BinaryIO] = None
        self._overflow = b""
        # a restored state's undelivered chunk tail, served before any read
        self._pending = b""
        self._chunk_bytes = max(int(chunk_bytes), 4096)
        self.reset_partition(part_index, num_parts)

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
        self.offset_begin = min(nstep * part_index, ntotal)
        self.offset_end = min(nstep * (part_index + 1), ntotal)
        self.offset_curr = self.offset_begin
        if self.offset_begin == self.offset_end:
            self._close_fp()
            self._overflow = self._pending = b""
            return
        file_ptr = bisect_right(self.file_offset, self.offset_begin) - 1
        file_ptr_end = bisect_right(self.file_offset, self.offset_end) - 1
        # adjust the end: extend to the next record head unless on a file join
        if self.offset_end != self.file_offset[file_ptr_end]:
            with self.fs.open_for_read(self.files[file_ptr_end].path) as f:
                f.seek(self.offset_end - self.file_offset[file_ptr_end])
                self.offset_end += _seek_record_begin(f)
        # adjust the begin the same way
        self.file_ptr = file_ptr
        if self.offset_begin != self.file_offset[file_ptr]:
            with self.fs.open_for_read(self.files[file_ptr].path) as f:
                f.seek(self.offset_begin - self.file_offset[file_ptr])
                self.offset_begin += _seek_record_begin(f)
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
        self._overflow = self._pending = b""

    # ---------------- reading ----------------

    def _read(self, size: int) -> bytes:
        """Read up to ``size`` payload bytes across file joins, injecting '\\n'
        at file joins (Read, input_split_base.cc:177-219)."""
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
            # file exhausted: newline injection at the join (input_split_base.cc:196-199)
            out += b"\n"
            nleft -= 1
            check(self.offset_curr == self.file_offset[self.file_ptr + 1],
                  "file offset not calculated correctly")
            if self.file_ptr + 1 >= len(self.files):
                break
            self.file_ptr += 1
            self._close_fp()
            self._fp = self.fs.open_for_read(self.files[self.file_ptr].path)
        return bytes(out)

    def _read_chunk(self, max_size: int) -> Optional[bytes]:
        """One chunk of whole lines; b'' means grow the buffer; None = EOF
        (ReadChunk, input_split_base.cc:221-258)."""
        if max_size <= len(self._overflow):
            return b""
        olen = len(self._overflow)
        data = self._overflow + self._read(max_size - olen)
        self._overflow = b""
        if len(data) == 0:
            return None
        if len(data) == olen:
            # final record of the partition lacked a newline (input_split_base.cc:235-242)
            data += b"\n"
        # position after the last EOL (line_split.cc:27-34); 0 if none
        cut = max(data.rfind(b"\n"), data.rfind(b"\r")) + 1
        self._overflow = data[cut:]
        return data[:cut]

    def next_chunk(self) -> Optional[bytes]:
        """The next chunk of whole lines, grown on demand for lines longer
        than the chunk size (Chunk::Load, input_split_base.cc:260-277);
        None at the end of the partition."""
        if self._pending:  # a restored chunk tail first (ExtractNextChunk)
            data, self._pending = self._pending, b""
            return data
        size = self._chunk_bytes
        while True:
            data = self._read_chunk(size)
            if data is None:
                return None
            if len(data) == 0:
                size *= 2
                continue
            return data

    # ---------------- checkpoint / resume ----------------

    @property
    def chunk_resume_state(self) -> dict:
        """The position just after the chunk :meth:`next_chunk` last
        returned: on this undecorated split, the live state."""
        return self.state_dict()

    def state_dict(self) -> dict:
        """Byte-exact resume point: the global offset and the undelivered
        buffer tails (the JAX package's ``kind="byte"`` state)."""
        return {
            "kind": "byte",
            "offset_curr": self.offset_curr,
            # tells a position on a file's end (its join '\n' not yet
            # injected) from the same offset at the next file's start
            "file_ptr": self.file_ptr,
            "overflow": self._overflow.hex(),
            "chunk": self._pending.hex(),
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
        self._pending = bytes.fromhex(state["chunk"])

    def _close_fp(self) -> None:
        if self._fp is not None:
            self._fp.close()
            self._fp = None

    def close(self) -> None:
        self._close_fp()


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

    def __init__(self, uri: str, part_index: int = 0, num_parts: int = 1,
                 chunk_bytes: int = DEFAULT_CHUNK_BYTES):
        self._maps: List[Optional[mmap.mmap]] = []
        self._views: List[Optional[memoryview]] = []
        super().__init__(uri, part_index, num_parts, chunk_bytes)
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
        return mv[lo:cut]

    def before_first(self) -> None:
        self.offset_curr = self.offset_begin
        self.file_ptr = min(max(bisect_right(self.file_offset, self.offset_begin) - 1, 0),
                            len(self.files) - 1)
        self._overflow = self._pending = b""

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
        self._overflow = self._pending = b""

    def close(self) -> None:
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


def create_mmap_text_split(uri: str, part_index: int = 0, num_parts: int = 1,
                           chunk_bytes: int = DEFAULT_CHUNK_BYTES) -> MmapLineSplit:
    """The zero-copy local text chunk source (the JAX package's factory of
    the same name)."""
    check(num_parts >= 1, f"num_parts must be >= 1, got {num_parts}")
    check(0 <= part_index < num_parts,
          f"part_index {part_index} out of range for {num_parts} parts")
    return MmapLineSplit(uri, part_index, num_parts, chunk_bytes=chunk_bytes)


def _seek_record_begin(stream: BinaryIO) -> int:
    """Bytes from the stream position to the next line head: scan to the
    first EOL, then past the EOL run (line_split.cc:9-26)."""
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
