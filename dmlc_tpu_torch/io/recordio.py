"""RecordIO: splittable binary record format.

Own copy of the JAX package's ``io/recordio.py`` (the behavioral
equivalent of reference include/dmlc/recordio.h + src/recordio.cc); the
bytes it writes and the records it reads are that module's. Wire format (recordio.h:17-45):

    [magic u32 LE][lrecord u32 LE][data][zero pad to 4-byte alignment]

- ``magic == 0xced7230a`` (recordio.h:45); note ``(magic >> 29) & 7 == 6 > 3``
  so an lrecord can never equal the magic.
- ``lrecord = (cflag << 29) | length`` with ``length < 2**29``
  (EncodeLRec, recordio.h:52-54).
- cflag 0: complete record; 1/2/3: start/middle/end of a multi-part record
  (recordio.h:33-36). Multi-part records arise when the data itself contains
  the magic u32 at a 4-byte-aligned offset: the writer splits the payload at
  each aligned magic cell and drops the cell; the reader re-inserts the magic
  between parts (recordio.cc:22-45, 74-79).

The magic scan is vectorized with numpy instead of the reference's per-cell
char loop (recordio.cc:22-27) — same escape positions, faster in Python.
"""

from __future__ import annotations

import struct
from typing import BinaryIO, Iterator, List, Optional, Tuple

import numpy as np

from dmlc_tpu_torch.utils.check import DMLCError, check

RECORDIO_MAGIC = 0xCED7230A
_MAGIC_BYTES = struct.pack("<I", RECORDIO_MAGIC)
_MAX_LEN = 1 << 29


def encode_lrec(cflag: int, length: int) -> int:
    return (cflag << 29) | length


def decode_flag(lrec: int) -> int:
    return (lrec >> 29) & 7


def decode_length(lrec: int) -> int:
    return lrec & (_MAX_LEN - 1)


def _aligned_magic_positions(data: bytes) -> np.ndarray:
    """4-aligned offsets where the payload contains the magic u32."""
    lower = (len(data) >> 2) << 2
    if lower == 0:
        return np.empty(0, dtype=np.int64)
    cells = np.frombuffer(data, dtype="<u4", count=lower >> 2)
    return np.flatnonzero(cells == RECORDIO_MAGIC).astype(np.int64) << 2


class RecordIOWriter:
    """Analog of dmlc::RecordIOWriter (recordio.cc:11-51)."""

    def __init__(self, stream: BinaryIO):
        self.stream = stream
        self.except_counter = 0  # number of magic-collision escapes performed

    def write_record(self, data: bytes) -> None:
        check(len(data) < _MAX_LEN, "RecordIO only accepts records < 2^29 bytes")
        positions = _aligned_magic_positions(data)
        dptr = 0
        out = self.stream
        for pos in positions:
            pos = int(pos)
            cflag = 1 if dptr == 0 else 2
            out.write(_MAGIC_BYTES)
            out.write(struct.pack("<I", encode_lrec(cflag, pos - dptr)))
            if pos != dptr:
                out.write(data[dptr:pos])
            dptr = pos + 4
            self.except_counter += 1
        cflag = 3 if dptr != 0 else 0
        out.write(_MAGIC_BYTES)
        out.write(struct.pack("<I", encode_lrec(cflag, len(data) - dptr)))
        if len(data) != dptr:
            out.write(data[dptr:])
        pad = (-len(data) + dptr) % 4
        # pad the final part to 4-byte alignment with zeros (recordio.cc:46-50)
        if pad:
            out.write(b"\x00" * pad)

    def tell(self) -> int:
        return self.stream.tell()


class RecordIOReader:
    """Analog of dmlc::RecordIOReader (recordio.cc:53-82)."""

    def __init__(self, stream: BinaryIO):
        self.stream = stream
        self._eos = False

    def next_record(self) -> Optional[bytes]:
        """Next logical record, multi-part frames reassembled; None at EOF."""
        if self._eos:
            return None
        parts: List[bytes] = []
        while True:
            header = self.stream.read(8)
            if len(header) == 0:
                self._eos = True
                return None
            check(len(header) == 8, "Invalid RecordIO File")
            magic, lrec = struct.unpack("<II", header)
            check(magic == RECORDIO_MAGIC, "Invalid RecordIO File")
            cflag = decode_flag(lrec)
            length = decode_length(lrec)
            upper = (length + 3) & ~3
            payload = self.stream.read(upper)
            check(len(payload) == upper, "Invalid RecordIO File (truncated payload)")
            parts.append(payload[:length])
            if cflag in (0, 3):
                break
            parts.append(_MAGIC_BYTES)
        return b"".join(parts)

    def __iter__(self) -> Iterator[bytes]:
        while True:
            rec = self.next_record()
            if rec is None:
                return
            yield rec


def find_record_heads(buf: bytes | memoryview) -> np.ndarray:
    """4-aligned offsets of record heads (magic + cflag in {0,1}) in ``buf``.

    Vectorized analog of FindNextRecordIOHead (recordio.cc:85-99): a head is
    an aligned magic cell whose following lrec cell has cflag 0 or 1.
    """
    mv = memoryview(buf)
    lower = (len(mv) >> 2) << 2
    if lower < 8:
        return np.empty(0, dtype=np.int64)
    cells = np.frombuffer(mv[:lower], dtype="<u4")
    is_magic = cells[:-1] == RECORDIO_MAGIC
    flags = (cells[1:] >> 29) & 7
    heads = np.flatnonzero(is_magic & (flags <= 1)).astype(np.int64) << 2
    return heads


class RecordIOChunkReader:
    """Extract records from one chunk blob, optionally sub-partitioned.

    Analog of dmlc::RecordIOChunkReader (recordio.cc:101-156): used to split
    one chunk across N parser threads (part_index/num_parts sub-partition with
    4-byte-aligned nstep, head-seek at both ends).
    """

    def __init__(self, chunk: bytes | memoryview, part_index: int = 0, num_parts: int = 1):
        chunk = memoryview(chunk)
        size = len(chunk)
        nstep = ((size + num_parts - 1) // num_parts + 3) & ~3
        begin = min(size, nstep * part_index)
        end = min(size, nstep * (part_index + 1))
        self._chunk = chunk
        self._begin = self._seek_head(chunk, begin)
        self._end = self._seek_head(chunk, end)

    @staticmethod
    def _seek_head(chunk: memoryview, start: int) -> int:
        # windowed scan: stop at the first head instead of scanning the whole
        # tail (the reference's FindNextRecordIOHead also stops early)
        n = len(chunk)
        window = 1 << 16
        pos = start
        while pos < n:
            stop = min(pos + window + 8, n)  # +8: catch a head spanning the edge
            heads = find_record_heads(chunk[pos:stop])
            if len(heads):
                return pos + int(heads[0])
            pos += window
        return n

    def next_record(self) -> Optional[memoryview | bytes]:
        """Next record payload; multi-part records are reassembled to bytes."""
        if self._begin >= self._end:
            return None
        rec, self._begin = extract_record(self._chunk, self._begin, self._end)
        return rec

    def __iter__(self):
        while True:
            rec = self.next_record()
            if rec is None:
                return
            yield rec


def extract_record(chunk: memoryview, begin: int, end: int) -> Tuple[memoryview | bytes, int]:
    """Parse one (possibly multi-part) record at ``begin``; return (payload, next).

    Shared by RecordIOChunkReader and the RecordIO input splitter
    (recordio_split.cc:44-82 does the same with in-place memmove; we return
    a zero-copy memoryview for whole records and joined bytes for the rare
    escaped multi-part case).
    """
    check(begin + 8 <= end, "Invalid RecordIO Format")
    magic, lrec = struct.unpack_from("<II", chunk, begin)
    check(magic == RECORDIO_MAGIC, "Invalid RecordIO Format")
    cflag = decode_flag(lrec)
    length = decode_length(lrec)
    payload_end = begin + 8 + length
    cursor = begin + 8 + ((length + 3) & ~3)
    check(cursor <= end, "Invalid RecordIO Format")
    if cflag == 0:
        return chunk[begin + 8: payload_end], cursor
    check(cflag == 1, "Invalid RecordIO Format")
    parts: List[bytes] = [bytes(chunk[begin + 8: payload_end])]
    while cflag != 3:
        check(cursor + 8 <= end, "Invalid RecordIO Format")
        magic, lrec = struct.unpack_from("<II", chunk, cursor)
        check(magic == RECORDIO_MAGIC, "Invalid RecordIO Format")
        cflag = decode_flag(lrec)
        length = decode_length(lrec)
        parts.append(_MAGIC_BYTES)
        parts.append(bytes(chunk[cursor + 8: cursor + 8 + length]))
        cursor += 8 + ((length + 3) & ~3)
    return b"".join(parts), cursor


# ---------------- indexed recordio helpers ----------------

def write_indexed_recordio(data_stream: BinaryIO, index_stream, records) -> int:
    """Write records + a text ``index offset`` index file.

    The index format is whitespace ``index offset`` pairs per line, as read
    by IndexedRecordIOSplitter::ReadIndexFile (indexed_recordio_split.cc:43-62).
    Returns the number of records written.
    """
    writer = RecordIOWriter(data_stream)
    n = 0
    for i, rec in enumerate(records):
        offset = data_stream.tell()
        line = f"{i} {offset}\n"
        try:
            index_stream.write(line.encode())
        except TypeError:  # text-mode index stream
            index_stream.write(line)
        writer.write_record(rec)
        n += 1
    return n


def read_index_file(stream: BinaryIO, total_bytes: int) -> List[Tuple[int, int]]:
    """Parse index file into sorted (offset, size) pairs.

    Mirrors ReadIndexFile (indexed_recordio_split.cc:43-62): offsets are
    sorted; each record's size is the gap to the next offset, the last one
    extends to ``total_bytes``.
    """
    text = stream.read()
    if isinstance(text, bytes):
        text = text.decode()
    offsets: List[int] = []
    tokens = text.split()
    if len(tokens) % 2 != 0:
        raise DMLCError("index file: expected 'index offset' pairs")
    for i in range(1, len(tokens), 2):
        offsets.append(int(tokens[i]))
    if not offsets:
        raise DMLCError("index file: empty")
    offsets.sort()
    out: List[Tuple[int, int]] = []
    for j in range(len(offsets) - 1):
        out.append((offsets[j], offsets[j + 1] - offsets[j]))
    out.append((offsets[-1], total_bytes - offsets[-1]))
    return out
