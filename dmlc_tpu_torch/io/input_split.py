"""Partitioned, line-aware input splitting — ``LineSplitter``.

Own copy of the JAX package's ``io/input_split.py`` (InputSplitBase +
LineSplitter), trimmed to what the port's parse path uses: byte-range
partitioning of local text files and whole-record chunk reads.

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
