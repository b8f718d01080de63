"""Text parsers — analog of src/data/{parser.h,text_parser.h,libsvm_parser.h,
csv_parser.h,libfm_parser.h} and the registry in src/data.cc.

Own copy of the JAX package's ``data/parsers.py`` for the three text
formats. Each chunk of a split partition goes through the C++ native
scanner (:mod:`dmlc_tpu_torch.native`) when it built, else through the
vectorized numpy engine; both emit identical blocks.

Semantics matched to the reference:

- libsvm: ``label[:weight] [qid:N] idx[:val]...``; ``#`` comments
  (libsvm_parser.h:67-84); missing values mean binary features;
  ``indexing_mode`` 1 means 1-based indices, 0 0-based, -1 the
  sklearn-style auto-detect per chunk (libsvm_parser.h:159-168);
- csv: dense rows with synthetic indices 0..k (csv_parser.h:120-121), the
  ``label_column`` / ``weight_column`` / one-character ``delimiter`` /
  ``dtype`` parameters;
- libfm: ``label field:idx:val...``; ``indexing_mode`` applies to field and
  index together (libfm_parser.h:130-143).

**The dense emit.** ``set_emit_dense(num_col)`` asks a libsvm or float32
csv parser on the native engine for :class:`DenseBlock` batches straight
from the scanner, skipping the CSR block (``DeviceIter(layout="dense")``
asks at construction). A libsvm chunk with qid rows switches the parser
back to CSR for good.

**The engine.** ``create_parser`` resolves the JAX package's engine
chain (:func:`create_parser`): a plain local file goes to the fused native
reader (:mod:`dmlc_tpu_torch.data.native_parser`), a plain file on another
registered filesystem (``mem://``, ``s3://``, ``gs://``, ``hdfs://``,
``azure://``, ``http://``) to its chunk feeder (``NativeFeedParser``),
``engine="native-batch"`` to the chunk-batch engine
(:mod:`dmlc_tpu_torch.data.batch_parser`), everything else (and
``engine="python"``, ``DMLC_TPU_NO_NATIVE_READER``) to the registry stack
below; all emit the same rows. The registry stack's formats are the
entries of :data:`PARSER_REGISTRY` (``Registry.get("parser")``): a format
registered there reaches ``create_parser``.

**The parse fan-out.** :class:`ParallelTextParser` pulls chunks serially
from the split (an :class:`~dmlc_tpu_torch.io.MmapLineSplit` for a plain
local file) and parses them on ``parse_workers`` threads, delivering the
blocks in pull order; :class:`ThreadedParser` is the one-lane chain.

Checkpoints follow the JAX package's ``TextParserBase`` and wrappers, key
for key. Each non-empty block carries ``resume_state = {"kind": "split",
"split": <the split's position just after the block>, "chunks": n}``; a
wrapper's :meth:`~ParallelTextParser.state_dict` is the last delivered
block's annotation plus ``blocks``, or ``{"kind": "blocks", "blocks": n}``
before the first block of an epoch. ``load_state`` seeks the split for a
``split`` state and replays the count for the other kinds, so a state
taken in either package restores in the other.

:class:`BlockCacheIter` is the parse-once block cache over that chain:
the first (cold) pass shadow-writes the parsed blocks into a columnar
cache file (:mod:`dmlc_tpu_torch.io.block_cache`), and warm epochs serve
them from it with no parse, in the epoch planner's seeded, resumable and
pod-sharded order (:mod:`dmlc_tpu_torch.data.epoch`) when
``create_parser``'s ``shuffle_seed`` / ``pod_sharding`` arm it.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import warnings
from typing import Callable, Dict, Iterator, Optional, Union

import numpy as np

from dmlc_tpu_torch import native
from dmlc_tpu_torch.data import epoch as _epoch
from dmlc_tpu_torch.data.row_block import DenseBlock, RowBlock
from dmlc_tpu_torch.io import block_cache as _bc
from dmlc_tpu_torch.io import resilience as _resilience
from dmlc_tpu_torch.io.input_split import (DEFAULT_CHUNK_BYTES, InputSplit,
                                           create_input_split, create_mmap_text_split)
from dmlc_tpu_torch.io.threaded_iter import OrderedWorkerPool
from dmlc_tpu_torch.io.uri import URISpec
from dmlc_tpu_torch.parallel.distributed import pod_identity
from dmlc_tpu_torch.utils import knobs as _knobs
from dmlc_tpu_torch.utils import telemetry as _telemetry
from dmlc_tpu_torch.utils.check import CacheCorruptionError, DMLCError, check, get_logger
from dmlc_tpu_torch.utils.params import Parameter, field
from dmlc_tpu_torch.utils.registry import Registry
from dmlc_tpu_torch.utils.timer import get_time


class Parser:
    """Single-pass RowBlock iterator — analog of dmlc::Parser (data.h:293-320)."""

    def next_block(self) -> Optional[RowBlock]:
        raise NotImplementedError

    def before_first(self) -> None:
        raise NotImplementedError

    def __iter__(self) -> Iterator[RowBlock]:
        while True:
            blk = self.next_block()
            if blk is None:
                return
            yield blk

    def close(self) -> None:
        pass


# ---------------- parameter structs ----------------

class LibSVMParserParam(Parameter):
    """libsvm_parser.h:24-39."""
    format = field(str, default="libsvm")
    indexing_mode = field(
        int, default=0, enum=[-1, 0, 1],
        help=">0: 1-based indices; 0: 0-based; <0: sklearn-style auto-detect.")


class CSVParserParam(Parameter):
    """csv_parser.h:23-40."""
    format = field(str, default="csv")
    label_column = field(int, default=-1, help="0-based column index of the label.")
    delimiter = field(str, default=",", help="Single-character field delimiter.")
    weight_column = field(int, default=-1, help="0-based column of instance weights.")
    dtype = field(str, default="float32", enum=["float32", "int32", "int64"],
                  help="Value dtype (data.cc instantiates real_t/int32/int64).")


class LibFMParserParam(Parameter):
    """libfm_parser.h:24-39."""
    format = field(str, default="libfm")
    indexing_mode = field(int, default=0, enum=[-1, 0, 1])


# ---------------- chunk parsers ----------------

class TextParserBase(Parser):
    """Pulls chunks from a split and parses each into a block (analog of
    TextParserBase::FillData, text_parser.h:110-146).

    Each chunk goes through the native scanner when it built, else the
    numpy engine (``create_parser(engine="python")`` pins numpy after the
    build, :func:`_pin_python_scanner`). A chunk the numpy engine cannot
    convert raises DMLCError, as the native one does.
    """

    # per-chunk native scanner threads, 0 the native default; the fan-out
    # pins it to 1, chunk-level parallelism replacing intra-chunk threads
    _parse_nthread: int = 0
    # fast-path probing: a corpus whose first chunks all reject the
    # _token_table signature stops paying the scan; one hit pins probing
    # on. Pool workers update both racily, which costs at most a few
    # extra scans, never wrong output
    _fast_rejects: int = 0
    _fast_saw_hit: bool = False
    # whether the native engine has a dense scanner for this format
    _dense_scanner: bool = False

    def __init__(self, source: InputSplit):
        self.source = source
        self._bytes = 0      # chunk bytes pulled, over the parser's life
        self._chunks_in = 0  # chunks pulled this epoch
        # None: not probed yet; False for the numpy engine
        self._native: Optional[bool] = None
        self._emit_dense: Optional[int] = None  # num_col while dense mode is on
        # cumulative seconds: chunk fetch (read) and chunk -> block (parse)
        self._read_seconds = 0.0
        self._parse_seconds = 0.0

    def set_emit_dense(self, num_col: int, batch_rows: int = 0, dtype: str = "float32",
                       pack_aux: bool = False) -> bool:
        """Opt in to :class:`DenseBlock` batches straight from the scanner;
        False when this parser has no dense scanner on its engine
        (RowBlocks as usual). ``batch_rows``, ``dtype`` and ``pack_aux``
        are the fused native reader's repack and are ignored here: the
        blocks are chunk-sized and float32, and ``DeviceIter`` packs them."""
        if self._dense_scanner and self.use_native():
            self._emit_dense = int(num_col)
            return True
        return False

    def use_native(self) -> bool:
        if self._native is None:
            self._native = native.available() and self._native_supported()
        return self._native

    def _native_supported(self) -> bool:
        return True

    @property
    def engine(self) -> str:
        """The engine in use: ``native`` or ``numpy``."""
        return "native" if self.use_native() else "numpy"

    def parse_chunk_native(self, chunk):
        raise NotImplementedError

    def parse_chunk(self, chunk):
        """``chunk``: bytes or a memoryview. The native scanners read a
        view's buffer in place; the numpy engine takes its bytes once."""
        if self.use_native():
            return self.parse_chunk_native(chunk)
        try:
            # overflow-range decimals (1e200) cast to float32 as inf — the
            # same saturation the native scanner applies
            with np.errstate(over="ignore"):
                return self.parse_chunk_py(_chunk_bytes(chunk))
        except (ValueError, TypeError) as exc:
            raise DMLCError(f"{type(self).__name__}: malformed input: {exc}") from exc

    def parse_chunk_py(self, chunk: bytes) -> RowBlock:
        raise NotImplementedError

    def stage_seconds(self) -> Dict[str, float]:
        """Cumulative ``{read, parse}`` seconds: chunk fetch at the split and
        chunk -> block conversion."""
        return {"read": self._read_seconds, "parse": self._parse_seconds}

    def _pull_chunk(self):
        """One serial chunk pull with its bookkeeping: the read seconds, the
        byte and chunk counts, and the resume annotation of the position
        just after the chunk (None when the split has no chunk-synchronized
        state: the chunk cache, the shuffle decorator, stdin). Shared by
        :meth:`next_block` and the fan-out's serial stage, so the two cannot
        annotate differently. ``(None, None)`` at the end of the stream."""
        t0 = get_time()
        chunk = self.source.next_chunk()
        dt = get_time() - t0
        self._read_seconds += dt
        # the span beside the seconds: one start, one duration
        _telemetry.record_span("read", t0, dt)
        if chunk is None:
            return None, None
        self._bytes += len(chunk)
        self._chunks_in += 1
        split_state = getattr(self.source, "chunk_resume_state", None)
        if split_state is None:
            return chunk, None
        return chunk, {"kind": "split", "split": split_state, "chunks": self._chunks_in}

    def next_block(self):
        while True:
            chunk, annot = self._pull_chunk()
            if chunk is None:
                return None
            t1 = get_time()
            block = self.parse_chunk(chunk)
            dt = get_time() - t1
            self._parse_seconds += dt
            _telemetry.record_span("parse", t1, dt)
            if len(block) > 0:
                # the position just AFTER this block: prefetching layers
                # downstream checkpoint byte-exactly through it
                if annot is not None:
                    block.resume_state = annot
                return block

    def before_first(self) -> None:
        self.source.before_first()
        self._chunks_in = 0

    def reset_partition(self, part_index: int, num_parts: int) -> None:
        """Re-point the parser at another partition of the same corpus
        (InputSplit::ResetPartition, io.h:190-242)."""
        self.source.reset_partition(part_index, num_parts)
        self._chunks_in = 0

    def state_dict(self) -> dict:
        """The split's position after the last chunk pulled, where the
        split has a chunk-synchronized state (an undecorated splitter, or
        the prefetching :class:`~dmlc_tpu_torch.io.input_split.\
ThreadedInputSplit`, whose chunks carry the position they were produced
        at); else the chunk count, replayed on restore."""
        split_state = getattr(self.source, "chunk_resume_state", None)
        if split_state is not None:
            return {"kind": "split", "split": split_state, "chunks": self._chunks_in}
        if self._chunks_in == 0 and hasattr(self.source, "state_dict"):
            # the epoch start: no chunk pulled yet, the live state is exact
            return {"kind": "split", "split": self.source.state_dict(), "chunks": 0}
        return {"kind": "chunks", "chunks": self._chunks_in}

    def load_state(self, state: dict) -> None:
        """Seek for a ``split`` state; replay the chunk count, without
        parsing, for a ``chunks`` state."""
        if state.get("kind") == "split" and hasattr(self.source, "load_state"):
            self.source.load_state(state["split"])
        else:
            self.before_first()
            for _ in range(int(state["chunks"])):
                if self.source.next_chunk() is None:
                    break
        self._chunks_in = int(state["chunks"])

    @property
    def bytes_read(self) -> int:
        return self._bytes

    def close(self) -> None:
        self.source.close()


def _chunk_bytes(chunk) -> bytes:
    """A chunk as bytes, without a copy when it already is bytes."""
    return chunk if isinstance(chunk, bytes) else bytes(chunk)


def _strip_comments(chunk: bytes) -> bytes:
    """Remove ``#``-to-EOL spans (IgnoreCommentAndBlank, libsvm_parser.h:67-84)."""
    if b"#" not in chunk:
        return chunk
    out = []
    for line in chunk.split(b"\n"):
        pos = line.find(b"#")
        out.append(line if pos < 0 else line[:pos])
    return b"\n".join(out)


def _tokenize_lines(chunk: bytes):
    """Split a text chunk into per-line token lists, skipping blanks.
    A UTF-8 BOM at chunk start is skipped (text_parser.h:81-95)."""
    if chunk.startswith(b"\xef\xbb\xbf"):
        chunk = chunk[3:]
    chunk = _strip_comments(chunk.replace(b"\r", b"\n"))
    lines = []
    for line in chunk.split(b"\n"):
        toks = line.split()
        if toks:
            lines.append(toks)
    return lines


def _apply_indexing_mode(index: np.ndarray, mode: int) -> np.ndarray:
    """1-based -> 0-based conversion per libsvm_parser.h:159-168."""
    if len(index) == 0:
        return index
    if mode > 0 or (mode < 0 and int(index.min()) > 0):
        return index - 1
    return index


def _empty_block() -> RowBlock:
    return RowBlock(np.zeros(1, np.int64), np.empty(0, np.float32), np.empty(0, np.uint64))


# bytes.split() whitespace, as a byte-indexed lookup table
_WS_LUT = np.zeros(256, bool)
_WS_LUT[[9, 10, 11, 12, 13, 32]] = True

# fast-path rejections (with no success yet) before a parser stops trying
# the fast path for good — the corpus structure never qualifies
_FAST_PATH_GIVEUP = 4


def _token_table(chunk: bytes, stride: int):
    """Vectorized structure scan for simple ``label f f f...`` chunks.

    Splits the whole chunk ONCE on whitespace+colon into one token array
    reused for label / field / index / value extraction, with the per-line
    structure derived from numpy mask scans instead of a per-line loop.
    ``stride`` is the sub-tokens a feature has (2: libsvm ``idx:val``, 3:
    libfm ``field:idx:val``). Returns ``(tokens, nnz, first_idx)``, or None
    when the chunk needs the general path (comments, qid, label:weight,
    binary or mixed features).
    """
    if b"#" in chunk or b"qid:" in chunk:
        return None
    if chunk.startswith(b"\xef\xbb\xbf"):
        chunk = chunk[3:]
    if b"\r" in chunk:
        chunk = chunk.replace(b"\r", b"\n")
    if not chunk:
        return None
    a = np.frombuffer(chunk, np.uint8)
    iscolon = a == 0x3A
    issep = _WS_LUT[a] | iscolon  # colons become separators in the split
    cpos = np.nonzero(iscolon)[0]
    if len(cpos):
        # every colon must be GLUED to non-separator bytes on both sides:
        # '2: 3' / '2 :3' / '2::3' / a chunk-edge colon would alias a clean
        # signature while the general path reads them otherwise
        if cpos[0] == 0 or cpos[-1] == len(a) - 1:
            return None
        if issep[cpos - 1].any() or issep[cpos + 1].any():
            return None
    prev = np.empty_like(issep)
    prev[0] = True
    prev[1:] = issep[:-1]
    tstart = ~issep & prev
    if not tstart.any():
        return None
    lid = np.cumsum(a == 0x0A)  # line id = newlines before each byte
    nlines = int(lid[-1]) + 1
    counts = np.bincount(lid[tstart], minlength=nlines)
    ccounts = np.bincount(lid[iscolon], minlength=nlines)
    live = counts > 0
    if np.any(ccounts[~live] > 0):
        return None  # colons on a token-less line: the general path rejects
    lc, cc = counts[live], ccounts[live]
    # every live line must be exactly label + nnz uniform features
    nnz, rem = np.divmod(lc - 1, stride)
    if rem.any() or not np.array_equal(cc, (stride - 1) * nnz):
        return None
    first_idx = np.zeros(len(lc), np.int64)
    np.cumsum(lc[:-1], out=first_idx[1:])
    # a colon attached to a line's first token is a label colon
    # (label:weight), which must take the general path
    line_first = np.full(nlines, -1, np.int64)
    line_first[np.nonzero(live)[0]] = first_idx
    tok_before = np.cumsum(tstart) - 1
    if np.any(tok_before[iscolon] == line_first[lid[iscolon]]):
        return None
    tokens = np.array(chunk.replace(b":", b" ").split())
    return tokens, nnz, first_idx


def _split_label_feats(tokens: np.ndarray, first_idx: np.ndarray):
    """(labels f32, the feature sub-tokens) from a :func:`_token_table` result."""
    label_mask = np.zeros(len(tokens), bool)
    label_mask[first_idx] = True
    return tokens[first_idx].astype(np.float32), tokens[~label_mask]


class LibSVMParser(TextParserBase):
    """libsvm text -> RowBlock (libsvm_parser.h:85-169)."""

    _dense_scanner = True

    def __init__(self, source: InputSplit, args: Dict[str, str] | None = None):
        super().__init__(source)
        self.param = LibSVMParserParam()
        self.param.init(dict(args or {}), allow_unknown=True)
        check(self.param.format == "libsvm", "LibSVMParser: format must be libsvm")

    def parse_chunk_native(self, chunk):
        # read once: a concurrent worker's qid fallback may clear it
        num_col = self._emit_dense
        if num_col is not None:
            try:
                x, label, weight, owner = native.parse_libsvm_dense(
                    chunk, num_col, nthread=self._parse_nthread,
                    indexing_mode=self.param.indexing_mode)
                return DenseBlock(x, label, weight, hold=owner)
            except native.NeedsCsrError:
                # qid rows, which the dense layout cannot carry: CSR for good
                self._emit_dense = None
        d = native.parse_libsvm(chunk, nthread=self._parse_nthread,
                                indexing_mode=self.param.indexing_mode)
        return RowBlock(offset=d["offset"], label=d["label"], index=d["index"],
                        value=d["value"], weight=d["weight"], qid=d["qid"],
                        hold=d["_owner"])

    def parse_chunk_py(self, chunk: bytes) -> RowBlock:
        fast = (_token_table(chunk, stride=2)
                if self._fast_saw_hit or self._fast_rejects < _FAST_PATH_GIVEUP
                else None)
        if fast is not None:
            self._fast_saw_hit = True
            tokens, nnz, first_idx = fast
            labels, feats = _split_label_feats(tokens, first_idx)
            offset = np.concatenate([[0], np.cumsum(nnz)])
            if len(feats) == 0:
                return RowBlock(offset=offset, label=labels,
                                index=np.empty(0, np.uint64))
            index = _apply_indexing_mode(feats[0::2].astype(np.int64),
                                         self.param.indexing_mode)
            return RowBlock(offset=offset, label=labels,
                            index=index.astype(np.uint64, copy=False),
                            value=feats[1::2].astype(np.float32))
        self._fast_rejects += 1
        lines = _tokenize_lines(chunk)
        n = len(lines)
        label_toks = []
        qid_vals: list = []
        has_qid = False
        nnz = np.empty(n, dtype=np.int64)
        feat_toks: list = []
        for i, toks in enumerate(lines):
            label_toks.append(toks[0])
            f = toks[1:]
            if f and f[0].startswith(b"qid:"):
                qid_vals.append(int(f[0][4:]))
                f = f[1:]
                has_qid = True
            elif has_qid:
                raise DMLCError("libsvm: qid must appear on every row or none")
            nnz[i] = len(f)
            feat_toks.extend(f)
        if has_qid and len(qid_vals) != n:
            raise DMLCError("libsvm: qid must appear on every row or none")
        if n == 0:
            return _empty_block()
        # labels (with optional :weight)
        label_arr = np.array(label_toks)
        if any(b":" in t for t in label_toks):
            pairs = np.char.partition(label_arr, b":")
            labels = pairs[:, 0].astype(np.float32)
            wcol = pairs[:, 2]
            if np.any(wcol == b""):
                raise DMLCError("libsvm: label:weight must be set on every row or none")
            weights = wcol.astype(np.float32)
        else:
            labels = label_arr.astype(np.float32)
            weights = None
        # features idx[:val]
        if feat_toks:
            blob = b" ".join(feat_toks)
            ncolon = blob.count(b":")
            if ncolon == len(feat_toks):
                nums = np.array(blob.replace(b":", b" ").split())
                index = nums[0::2].astype(np.int64)
                value = nums[1::2].astype(np.float32)
            elif ncolon == 0:
                index = np.array(feat_toks).astype(np.int64)
                value = None
            else:
                # mixed: missing values read as 1.0
                parts = np.char.partition(np.array(feat_toks), b":")
                index = parts[:, 0].astype(np.int64)
                vals = parts[:, 2]
                value = np.where(vals == b"", b"1", vals).astype(np.float32)
        else:
            index = np.empty(0, np.int64)
            value = None
        index = _apply_indexing_mode(index, self.param.indexing_mode)
        return RowBlock(
            offset=np.concatenate([[0], np.cumsum(nnz)]),
            label=labels,
            index=index.astype(np.uint64, copy=False),
            value=value,
            weight=weights,
            qid=np.array(qid_vals, np.int64) if has_qid else None,
        )


class CSVParser(TextParserBase):
    """Dense csv -> RowBlock with synthetic indices (csv_parser.h:85-146).
    The native scanner reads float32 cells only: another ``dtype`` takes
    the numpy engine."""

    _dense_scanner = True

    def __init__(self, source: InputSplit, args: Dict[str, str] | None = None):
        super().__init__(source)
        self.param = CSVParserParam()
        self.param.init(dict(args or {}), allow_unknown=True)
        check(self.param.format == "csv", "CSVParser: format must be csv")
        check(len(self.param.delimiter) == 1, "CSVParser: delimiter must be one char")
        check(self.param.label_column != self.param.weight_column
              or self.param.label_column < 0,
              "CSVParser: label_column must differ from weight_column")
        self._dtype = np.dtype(self.param.dtype)

    def _native_supported(self) -> bool:
        return self.param.dtype == "float32"

    def parse_chunk_native(self, chunk):
        cells, owner = native.parse_csv(chunk, delimiter=self.param.delimiter,
                                        nthread=self._parse_nthread)
        n, ncol = cells.shape
        if n == 0:
            return _empty_block()
        if self._emit_dense is not None:
            return csv_cells_to_dense(cells, n, ncol, self._emit_dense,
                                      self.param.label_column, self.param.weight_column,
                                      owner)
        return csv_cells_to_block(cells, n, ncol, self.param.label_column,
                                  self.param.weight_column)

    def parse_chunk_py(self, chunk: bytes) -> RowBlock:
        if chunk.startswith(b"\xef\xbb\xbf"):
            chunk = chunk[3:]
        delim = self.param.delimiter.encode()
        norm = chunk.replace(b"\r", b"\n")
        rows = [r for r in norm.split(b"\n") if r]
        n = len(rows)
        if n == 0:
            return _empty_block()
        ncol = rows[0].count(delim) + 1
        # one vectorized conversion of the whole chunk
        tokens = np.array(norm.replace(delim, b" ").split())
        if len(tokens) != n * ncol:
            raise DMLCError(f"csv: ragged chunk - expected {n}x{ncol} cells, got {len(tokens)}")
        cells = tokens.astype(self._dtype).reshape(n, ncol)
        return csv_cells_to_block(cells, n, ncol, self.param.label_column,
                                  self.param.weight_column)


def csv_cells_to_dense(cells: np.ndarray, n: int, ncol: int, num_col: int,
                       label_column: int, weight_column: int, owner) -> DenseBlock:
    """A cell matrix -> DenseBlock; zero-copy when there are no label or
    weight columns and the width already matches."""
    lc, wc = label_column, weight_column
    check(lc < ncol, f"csv: label_column {lc} >= num columns {ncol}")
    check(wc < ncol, f"csv: weight_column {wc} >= num columns {ncol}")
    label = cells[:, lc].astype(np.float32) if lc >= 0 else np.zeros(n, np.float32)
    weight = cells[:, wc].astype(np.float32) if wc >= 0 else None
    if lc < 0 and wc < 0 and ncol == num_col:
        return DenseBlock(cells, label, weight, hold=owner)
    feat_cols = [c for c in range(ncol) if c != lc and c != wc]
    k = min(len(feat_cols), num_col)
    x = np.zeros((n, num_col), np.float32)
    x[:, :k] = cells[:, feat_cols[:k]]
    return DenseBlock(x, label, weight, hold=owner)


# synthetic CSR skeletons for csv blocks: every row has the same k column
# indices and k-strided offsets, and chunk-sized blocks repeat their
# geometry, so one (n, k) build serves the stream. Lock-guarded, as the
# fan-out's workers share it; read-only, as every block of the stream does
_CSV_SKELETON_CACHE: dict = {}
_CSV_SKELETON_LOCK = threading.Lock()


def _csv_skeleton(n: int, k: int):
    key = (n, k)
    with _CSV_SKELETON_LOCK:
        hit = _CSV_SKELETON_CACHE.get(key)
        if hit is not None:
            return hit
    # built outside the lock; concurrent builders of one key converge on
    # whichever insert wins
    index = np.tile(np.arange(k, dtype=np.uint64), n)
    # k == 0 (every column is label or weight) is legal: all offsets 0
    offset = np.arange(0, (n + 1) * k, k, dtype=np.int64) if k else np.zeros(n + 1, np.int64)
    index.flags.writeable = False
    offset.flags.writeable = False
    with _CSV_SKELETON_LOCK:
        hit = _CSV_SKELETON_CACHE.get(key)
        if hit is None:
            if len(_CSV_SKELETON_CACHE) > 64:  # block geometries are few
                _CSV_SKELETON_CACHE.clear()
            hit = (index, offset)
            _CSV_SKELETON_CACHE[key] = hit
    return hit


def csv_cells_to_block(cells: np.ndarray, n: int, ncol: int, label_column: int,
                       weight_column: int) -> RowBlock:
    """A cell matrix -> RowBlock with synthetic indices 0..k
    (csv_parser.h:120-121), shared by the native and numpy engines."""
    lc, wc = label_column, weight_column
    check(lc < ncol, f"csv: label_column {lc} >= num columns {ncol}")
    check(wc < ncol, f"csv: weight_column {wc} >= num columns {ncol}")
    feat_cols = [c for c in range(ncol) if c != lc and c != wc]
    k = len(feat_cols)
    # contiguous feature columns (label/weight at the edges, the Criteo
    # case) take one copy; the general fancy index takes two
    lo = min(feat_cols) if k else 0
    if k and feat_cols == list(range(lo, lo + k)) and cells.dtype == np.float32:
        values = np.ascontiguousarray(cells[:, lo:lo + k])
    else:
        values = np.ascontiguousarray(cells[:, feat_cols].astype(np.float32, copy=False))
    label = cells[:, lc].astype(np.float32) if lc >= 0 else np.zeros(n, np.float32)
    weight = cells[:, wc].astype(np.float32) if wc >= 0 else None
    index, offset = _csv_skeleton(n, k)
    return RowBlock(offset=offset, label=label, index=index,
                    value=values.reshape(-1), weight=weight)


class LibFMParser(TextParserBase):
    """libfm ``label field:idx:val`` -> RowBlock (libfm_parser.h:85-143)."""

    def __init__(self, source: InputSplit, args: Dict[str, str] | None = None):
        super().__init__(source)
        self.param = LibFMParserParam()
        self.param.init(dict(args or {}), allow_unknown=True)
        check(self.param.format == "libfm", "LibFMParser: format must be libfm")

    def parse_chunk_native(self, chunk):
        d = native.parse_libfm(chunk, nthread=self._parse_nthread,
                               indexing_mode=self.param.indexing_mode)
        return RowBlock(offset=d["offset"], label=d["label"], index=d["index"],
                        value=d["value"], field=d["field"], hold=d["_owner"])

    def parse_chunk_py(self, chunk: bytes) -> RowBlock:
        fast = (_token_table(chunk, stride=3)
                if self._fast_saw_hit or self._fast_rejects < _FAST_PATH_GIVEUP
                else None)
        if fast is not None:
            self._fast_saw_hit = True
            tokens, nnz, first_idx = fast
            labels, feats = _split_label_feats(tokens, first_idx)
        else:
            self._fast_rejects += 1
            lines = _tokenize_lines(chunk)
            n = len(lines)
            if n == 0:
                return _empty_block()
            nnz = np.array([len(toks) - 1 for toks in lines], np.int64)
            labels = np.array([toks[0] for toks in lines]).astype(np.float32)
            feat_toks = [t for toks in lines for t in toks[1:]]
            feats = np.empty(0, "S1")
            if feat_toks:
                blob = b" ".join(feat_toks)
                check(blob.count(b":") == 2 * len(feat_toks),
                      "libfm: features must be field:index:value triples")
                feats = np.array(blob.replace(b":", b" ").split())
        if len(feats):
            fields = feats[0::3].astype(np.int64)
            index = feats[1::3].astype(np.int64)
            value = feats[2::3].astype(np.float32)
        else:
            fields = np.empty(0, np.int64)
            index = np.empty(0, np.int64)
            value = None
        mode = self.param.indexing_mode
        # the heuristic shifts field and index together (libfm_parser.h:130-143)
        if len(index) and (mode > 0 or (mode < 0 and int(index.min()) > 0
                                        and int(fields.min()) > 0)):
            index = index - 1
            fields = fields - 1
        return RowBlock(offset=np.concatenate([[0], np.cumsum(nnz)]), label=labels,
                        index=index.astype(np.uint64, copy=False), value=value,
                        field=fields.astype(np.uint64, copy=False))


def annot_key(state: Optional[dict]) -> str:
    """The comparison key of a resume annotation: without the wrapper's
    ``blocks`` counter, through JSON, keys sorted (the JAX package's
    ``annot_key``)."""
    norm = {k: v for k, v in (state or {}).items() if k != "blocks"}
    return json.dumps(json.loads(json.dumps(norm, default=str)), sort_keys=True)


class ParallelTextParser(Parser):
    """The chunk-parse fan-out (the reference fans each chunk across OS
    threads, text_parser.h:110-146).

    Chunks are pulled SERIALLY from the base's split, each with its
    ``chunk_resume_state`` captured at the pull (the serial stage of an
    :class:`~dmlc_tpu_torch.io.threaded_iter.OrderedWorkerPool`); then
    ``parse_chunk`` runs on ``num_workers`` threads at once, with the
    native scanner pinned to one lane (``_parse_nthread = 1``) when there
    are several. Blocks are delivered in pull order, so the blocks and
    their annotations are the serial stream's, at every worker count.
    Production starts on the first pull, so ``set_emit_dense`` still
    reaches the base before it. ``stage_seconds()`` sums the workers'
    parse seconds under a lock, and :meth:`parallel_stats` reports the
    width and the measured parallel efficiency. A parse error is raised at
    its chunk's place in the stream. An opt-in ``restart_policy``
    (:class:`~dmlc_tpu_torch.io.resilience.RetryPolicy`) heals a retryable
    error of a chunk pull inside the pool: the split goes back to the
    pool's origin (its state when the pool started; the epoch start when
    it has none) and the chunks already pulled are skipped, so the blocks
    are those of a clean run (``parse_restarts`` / ``parse_giveups``
    count it). :meth:`resize_parse_workers` changes the width live (the
    autotuner's ``parse_workers`` knob): chunks keep being pulled serially
    and delivered in pull order, so the blocks and their annotations are
    those of a run at one width.

    Its position runs ahead of delivery, so a checkpoint is the annotation
    of the last block delivered; ``load_state`` stops the production first
    and seeks (``kind="split"``) or replays a block count
    (``kind="blocks"``), and the next pull starts production where the
    base then stands.
    """

    def __init__(self, base: TextParserBase, num_workers: int = 2,
                 restart_policy: Optional[_resilience.RetryPolicy] = None):
        self.base = base
        self.num_workers = max(1, int(num_workers))
        # a couple of chunks in flight a worker rides out parse-time variance
        self._ahead = max(4, 2 * self.num_workers)
        self._restart_policy = restart_policy
        base._parse_nthread = 1 if self.num_workers > 1 else 0
        self._pool: Optional[OrderedWorkerPool] = None
        self._delivered = 0
        self._last_annot: Optional[dict] = None
        self._stage_lock = threading.Lock()
        # the current span (since the last quiesce): first parse start,
        # last parse end, and the busy seconds at its start
        self._parse_t_first: Optional[float] = None
        self._parse_t_last: Optional[float] = None
        self._parse_busy0 = base._parse_seconds

    def _chunk_stream(self):
        """The pool's serial stage: the base's own pull-and-annotate step,
        under the pool's pull lock (one reader of the split)."""
        while True:
            chunk, annot = self.base._pull_chunk()
            if chunk is None:
                return
            yield chunk, annot

    def _parse_work(self, item):
        """The pool's parallel stage: chunk -> block, annotated."""
        chunk, annot = item
        t0 = get_time()
        try:
            block = self.base.parse_chunk(chunk)
        finally:
            t1 = get_time()
            _telemetry.record_span("parse", t0, t1 - t0)
            with self._stage_lock:
                self.base._parse_seconds += t1 - t0
                if self._parse_t_first is None or t0 < self._parse_t_first:
                    self._parse_t_first = t0
                if self._parse_t_last is None or t1 > self._parse_t_last:
                    self._parse_t_last = t1
        if len(block) > 0:
            block.resume_state = annot
        return block

    def _quiesce(self) -> None:
        if self._pool is not None:
            self._pool.destroy()
            self._pool = None
        with self._stage_lock:
            # a fresh efficiency span: the gap until the next parse is the
            # consumer's idle time, not the workers'
            self._parse_t_first = self._parse_t_last = None
            self._parse_busy0 = self.base._parse_seconds

    @property
    def engine(self) -> str:
        return self.base.engine

    def set_emit_dense(self, num_col: int, batch_rows: int = 0, dtype: str = "float32",
                       pack_aux: bool = False) -> bool:
        # once production runs, blocks of both kinds would mix: decline
        return self._pool is None and self.base.set_emit_dense(num_col)

    def _ensure_pool(self) -> OrderedWorkerPool:
        """The pool, started at the base's current position. A restart goes
        back to that origin (the split's state, or its chunk-synchronized
        resume state after a seek), rewinds the byte and chunk counters and
        replays from there; with no origin, away from the stream's start,
        the pool restarts nothing and the error propagates."""
        if self._pool is None:
            src = self.base.source
            origin = None
            if hasattr(src, "state_dict"):
                try:
                    origin = src.state_dict()
                except (DMLCError, AttributeError):
                    origin = None
            if origin is None:
                origin = getattr(src, "chunk_resume_state", None)
            at_start = self.base._chunks_in == 0 and self._delivered == 0
            policy = (self._restart_policy
                      if (origin is not None and hasattr(src, "load_state")) or at_start
                      else None)
            counters0 = (self.base._bytes, self.base._chunks_in)
            first = [True]

            def factory():
                if not first[0]:
                    self.base._bytes, self.base._chunks_in = counters0
                    if origin is not None and hasattr(src, "load_state"):
                        src.load_state(origin)
                    else:
                        src.before_first()
                first[0] = False
                return self._chunk_stream()

            self._pool = OrderedWorkerPool(factory, self._parse_work,
                                           num_workers=self.num_workers,
                                           max_ahead=self._ahead, restart_policy=policy,
                                           counter_label="parse")
        return self._pool

    def resize_parse_workers(self, num_workers: int) -> bool:
        """Change the width live (the autotuner's ``parse_workers`` knob):
        the running pool grows or shrinks in place, the window follows
        (``max(4, 2 * n)``), and at one worker the base may thread its
        scanner again. Always True."""
        n = max(1, int(num_workers))
        self.num_workers = n
        self.base._parse_nthread = 1 if n > 1 else 0
        self._ahead = max(4, 2 * n)
        if self._pool is not None:
            self._pool.resize(n)
            self._pool.set_max_ahead(self._ahead)
        return True

    def next_block(self):
        self._ensure_pool()
        while True:
            block = self._pool.next()
            if block is None:
                return None
            if len(block) == 0:
                continue  # an empty chunk gives no block, as in the base
            self._delivered += 1
            self._last_annot = block.resume_state
            return block

    def before_first(self) -> None:
        self._quiesce()
        self.base.before_first()
        self._delivered = 0
        self._last_annot = None

    def reset_partition(self, part_index: int, num_parts: int) -> None:
        self._quiesce()
        self.base.reset_partition(part_index, num_parts)
        self._delivered = 0
        self._last_annot = None

    def state_dict(self) -> dict:
        if self._last_annot is not None:
            return dict(self._last_annot, blocks=self._delivered)
        return {"kind": "blocks", "blocks": self._delivered}

    def load_state(self, state: dict) -> None:
        self._quiesce()
        if state.get("kind") == "split":
            self.base.load_state(state)
            self._delivered = int(state.get("blocks", 0))
            self._last_annot = {k: v for k, v in state.items() if k != "blocks"}
            return
        n = int(state["blocks"])
        self.base.before_first()
        for _ in range(n):
            if self.base.next_block() is None:
                break
        # the replay parsed on the base: a fresh efficiency span after it
        self._quiesce()
        self._delivered = n
        self._last_annot = None

    def stage_seconds(self) -> Dict[str, float]:
        with self._stage_lock:
            return dict(self.base.stage_seconds())

    def parallel_stats(self) -> Optional[dict]:
        """The width and the measured parallel efficiency: parse busy
        seconds over the current span (since the last epoch reset,
        repartition or restore) over ``span * workers``, 1.0 when every
        worker parsed the whole span, None before any parse.
        ``parse_busy_seconds`` is cumulative, as ``stage_seconds()["parse"]``."""
        with self._stage_lock:
            busy = self.base._parse_seconds
            span_busy = busy - self._parse_busy0
            span = (self._parse_t_last - self._parse_t_first
                    if self._parse_t_first is not None else 0.0)
        eff = min(1.0, span_busy / (span * self.num_workers)) if span > 0 else None
        return {"parse_workers": self.num_workers, "parse_busy_seconds": busy,
                "parse_span_seconds": span, "parse_parallelism_efficiency": eff}

    @property
    def bytes_read(self) -> int:
        return self.base.bytes_read

    def close(self) -> None:
        self._quiesce()
        self.base.close()


class ThreadedParser(ParallelTextParser):
    """Parse-ahead decorator — analog of ThreadedParser (parser.h:70-126):
    the fan-out at one lane, under the JAX package's name. Like the JAX
    class it reports no :meth:`parallel_stats`."""

    # one lane, as the JAX class: no live width, so no autotuner parse knob
    resize_parse_workers = None

    def __init__(self, base: TextParserBase):
        super().__init__(base, num_workers=1)

    def parallel_stats(self) -> Optional[dict]:
        return None


class BlockCacheIter(Parser):
    """Parse-once decorator: a cold pass tees the parsed RowBlocks into the
    columnar block cache (:mod:`dmlc_tpu_torch.io.block_cache`) and
    publishes it at the source's end; warm epochs serve the blocks from the
    cache file with no parse and no source read.

    ``base`` is a :class:`Parser` or a zero-argument factory of one, called
    only for a cold pass or a rebuild, so warm epochs never build the
    parser chain. The JAX package's ``BlockCacheIter``, contract for
    contract:

    - **checkpoints**: a cold block's ``resume_state`` is stored in the
      footer and re-attached to the warm block, so a ``DeviceIter`` state
      taken warm equals one taken cold at the same row. :meth:`load_state`
      takes the four state shapes: ``block_cache`` (a warm position),
      ``blocks`` (a delivered count), the parser chain's ``split`` (found
      in the cache by its annotation) and ``epoch_plan``;
    - **attribution**: :attr:`cache_state` is ``cold`` / ``warm``;
      ``stage_seconds()["cache_read"]`` the time spent reading warm
      blocks (crc, copies and row gathers included); :attr:`bytes_read` the
      base parser's source bytes plus the cache bytes served;
    - **healing**: a block that fails its crc32
      (:class:`~dmlc_tpu_torch.utils.check.CacheCorruptionError`) drops the
      cache and counts ``cache_corruptions`` and ``cache_rebuilds``
      (:mod:`dmlc_tpu_torch.io.resilience`). A sequential warm epoch goes
      on cold from the broken block, re-parsing and rewriting the whole
      cache; a plan-ordered one rebuilds the cache in one silent pass and
      goes on at the same plan position. The stream is unchanged.

    **The epoch plan** (``shuffle_seed``, ``shuffle_window``, ``host_id`` /
    ``num_hosts``): every warm epoch serves its blocks through an
    :class:`~dmlc_tpu_torch.data.epoch.EpochPlan`, a seeded block
    permutation plus a windowed row shuffle, both functions of ``(seed,
    epoch)``, with ``num_hosts > 1`` keeping this host's round-robin shard.
    The epoch counter advances on each :meth:`before_first` that follows a
    pass, and stays put for back-to-back rewinds with nothing delivered. A
    cold pass is sequential: it shadow-writes every block, and with
    ``num_hosts > 1`` delivers every ``num_hosts``-th from ``host_id`` (its
    annotations then carry the shard cursor as ``cold`` / ``seen``). Plan
    blocks are read ahead on ``plan_read_workers`` threads
    (:class:`~dmlc_tpu_torch.io.threaded_iter.OrderedWorkerPool`), each
    copied or row-gathered off the mmap, and carry ``kind="epoch_plan"``
    annotations, ``(seed, epoch, position)``, so a mid-epoch restore
    replays the stream byte for byte. A sequential state restored into a
    plan pipeline serves the rest of its epoch sequentially.

    The autotuner reaches the tiers through :meth:`resize_parse_workers`
    (the base chain's fan-out on a cold pass; False while warm, when no
    parse runs) and :meth:`resize_plan_read_workers` (the running plan pool
    and every later one); ``parse_workers_hint``, stamped by
    :func:`create_parser`, is the width a lazily built base will use. The
    JAX package's profiler annotations are not ported.
    """

    def __init__(self, base: Union[Parser, Callable[[], Parser]], cache_file: str,
                 signature: Optional[dict] = None,
                 shuffle_seed: Optional[int] = None, shuffle_window: int = 0,
                 host_id: int = 0, num_hosts: int = 1):
        check(num_hosts >= 1 and 0 <= host_id < num_hosts,
              f"BlockCacheIter: host_id {host_id} not in [0, {num_hosts})")
        self._base_factory = base if callable(base) else (lambda: base)
        self._base: Optional[Parser] = None if callable(base) else base
        self.cache_file = cache_file
        self._signature = signature
        self._reader: Optional[_bc.BlockCacheReader] = None
        self._writer: Optional[_bc.BlockCacheWriter] = None
        self._mode = "cold"
        self._pos = 0        # warm: the next plan position / block index
        self._skip = 0       # cold: blocks to shadow-write but not deliver
        self._shadow = True  # this pass may shadow-write
        self._delivered = 0
        self._bytes = 0      # cache bytes served
        self._cache_read_seconds = 0.0
        self._cr_lock = threading.Lock()  # the plan readers add to it
        # cumulative seconds of the cold pass's cache writes (the tee and the
        # publish), each also a cache_write span: DeviceIter leaves them out
        # of the parse span it records for the rest of a pull
        self.cache_write_seconds = 0.0
        # DMLC_TPU_TRACE=1: the warm reads in profiler ranges
        self._annotate = _telemetry.trace_mode()[0] == "annotate"
        self._seed = None if shuffle_seed is None else int(shuffle_seed)
        self._window = int(shuffle_window)
        self._host_id = int(host_id)
        self._num_hosts = int(num_hosts)
        self._epoch = 0
        self._plan: Optional[_epoch.EpochPlan] = None  # built lazily, warm
        self._seq_restore = False  # a sequential state owns this epoch's rest
        self._cold_seen = 0        # cold: blocks seen this pass, before the filter
        self._plan_pool: Optional[OrderedWorkerPool] = None
        self.plan_read_workers = _knobs.resolve("plan_read_workers")
        # per-block verdicts of uniform_column_pattern: the same every epoch
        self._uniform_cols: Dict[int, bool] = {}
        self._open_reader()

    @property
    def _plan_armed(self) -> bool:
        """A plan orders warm serving (a seed, or more than one host)."""
        return self._seed is not None or self._num_hosts > 1

    @property
    def cache_state(self) -> str:
        """``warm`` when blocks come from the cache, else ``cold``."""
        return "warm" if self._mode == "warm" else "cold"

    @property
    def plan_state(self) -> Optional[dict]:
        """The planner's identity, None without a plan: seed, epoch,
        position, window and sharding, and ``order``: ``plan`` when this
        pass serves in plan order, ``sequential`` for a cold pass or a
        sequential restore."""
        if not self._plan_armed:
            return None
        sequential = self._mode != "warm" or self._seq_restore or self._seed is None
        return {"shuffle_seed": self._seed, "epoch": self._epoch, "pos": self._pos,
                "window": self._window, "host_id": self._host_id,
                "num_hosts": self._num_hosts,
                "order": "sequential" if sequential else "plan"}

    @property
    def base(self) -> Parser:
        if self._base is None:
            self._base = self._base_factory()
        return self._base

    # ---------------- the cache file ----------------

    def _open_reader(self) -> bool:
        reader = _bc.open_block_cache(self.cache_file, self._signature)
        if reader is None:
            self._mode = "cold"
            return False
        self._reader = reader
        self._mode = "warm"
        self._pos = 0
        self._uniform_cols.clear()  # the verdicts are per published cache
        return True

    def _drop_reader(self) -> None:
        reader, self._reader = self._reader, None
        if reader is not None:
            reader.close()

    def _abort_writer(self) -> None:
        writer, self._writer = self._writer, None
        if writer is not None:
            writer.abort()

    def _ensure_writer(self) -> Optional[_bc.BlockCacheWriter]:
        if self._writer is None and self._shadow:
            self._writer = _bc.BlockCacheWriter(self.cache_file, signature=self._signature)
        return self._writer

    @staticmethod
    def _tee_block(writer: _bc.BlockCacheWriter, block: RowBlock, annot) -> None:
        """Shadow-write one parsed block: a ``native-batch`` block's span
        (``block.encoded``) as it is, any other through the segment
        encoder; the files are the same bytes either way."""
        encoded = getattr(block, "encoded", None)
        if encoded is not None:
            writer.add_block_encoded(encoded, resume=annot)
        else:
            writer.add_block(block.to_segments(), rows=len(block), num_col=block.num_col,
                             resume=annot)

    def _add_cache_read(self, t0: float) -> None:
        """A warm read that started at ``t0`` ends now: its seconds and
        its ``cache_read`` span."""
        dt = get_time() - t0
        with self._cr_lock:
            self._cache_read_seconds += dt
        _telemetry.record_span("cache_read", t0, dt)

    # ---------------- delivery ----------------

    def next_block(self) -> Optional[RowBlock]:
        if self._mode == "warm":
            if self._plan_armed and not self._seq_restore:
                return self._next_warm_plan()
            return self._next_warm()
        return self._next_cold()

    def _next_warm(self) -> Optional[RowBlock]:
        reader = self._reader
        while self._pos < reader.num_blocks:
            i = self._pos
            if self._seq_restore and self._num_hosts > 1 and i % self._num_hosts != self._host_id:
                # a restored sharded cold stream: the cold pass's round-robin
                # filter by sequential block index
                self._pos += 1
                continue
            t0 = get_time()
            try:
                with _telemetry.profiler_annotation("dmlc_tpu.cache_read", self._annotate):
                    segments = reader.load_segments(i)
            except CacheCorruptionError:
                self._add_cache_read(t0)
                self._heal_corruption()
                return self._next_cold()
            block = RowBlock.from_segments(segments, hold=reader.hold)
            # the block's span rides along: a consumer that appends blocks
            # (a tee) reuses the mmap's bytes with no re-encode
            block.encoded = reader.block_encoded(i)
            annot = reader.resume(i)
            if annot is not None:
                block.resume_state = annot
            self._bytes += reader.block_nbytes(i)
            self._add_cache_read(t0)
            self._pos += 1
            self._delivered += 1
            return block
        return None

    def _ensure_plan(self) -> _epoch.EpochPlan:
        if self._plan is None:
            self._plan = _epoch.EpochPlan(
                self._seed, self._epoch, self._reader.num_blocks, num_hosts=self._num_hosts,
                host_id=self._host_id, window=self._window)
        return self._plan

    def _plan_read_work(self, pos: int):
        """One plan-ordered block read, on a pool thread: copied off the
        mmap (or row-gathered, which copies) inside the timed read, so a
        permuted read's page faults are counted as ``cache_read``."""
        plan, reader = self._plan, self._reader
        bidx = plan.block_at(pos)
        t0 = get_time()
        try:
            with _telemetry.profiler_annotation("dmlc_tpu.cache_read", self._annotate):
                rowperm = plan.row_order(bidx, reader.block_rows(bidx))
                copy = rowperm is None and plan.permuted
                segments = reader.load_segments(bidx, copy=copy)
                # a row gather may pass the permutation-invariant index
                # array through as a view: the mmap stays held then
                block = RowBlock.from_segments(segments, hold=None if copy else reader.hold)
                if rowperm is not None:
                    uniform = self._uniform_cols.get(bidx)
                    if uniform is None:
                        uniform = _epoch.uniform_column_pattern(block)
                        self._uniform_cols[bidx] = uniform
                    block = _epoch.permute_block_rows(block, rowperm, uniform_columns=uniform)
        finally:
            self._add_cache_read(t0)
        return block, reader.block_nbytes(bidx)

    def _quiesce_plan_pool(self) -> None:
        pool, self._plan_pool = self._plan_pool, None
        if pool is not None:
            pool.destroy()

    def _ensure_plan_pool(self) -> OrderedWorkerPool:
        if self._plan_pool is None:
            plan, start = self._ensure_plan(), self._pos
            self._plan_pool = OrderedWorkerPool(
                lambda: iter(range(start, len(plan))), self._plan_read_work,
                num_workers=self.plan_read_workers, max_ahead=2 * self.plan_read_workers)
        return self._plan_pool

    def _next_warm_plan(self) -> Optional[RowBlock]:
        plan = self._ensure_plan()
        healed = 0
        while self._pos < len(plan):
            pool = self._ensure_plan_pool()
            try:
                item = pool.next()
            except CacheCorruptionError:
                check(healed == 0,
                      f"block cache {self.cache_file}: still corrupt after a full rebuild")
                healed += 1
                self._quiesce_plan_pool()
                self._rebuild_cache(corruption=True)
                # the rebuilt cache holds the same blocks: the same plan goes
                # on at the failed position
                continue
            if item is None:
                return None
            block, nbytes = item
            block.resume_state = plan.state(self._pos + 1)
            self._bytes += nbytes
            self._pos += 1
            self._delivered += 1
            return block
        return None

    def _rebuild_cache(self, corruption: bool = False) -> None:
        """Drain the source into a fresh cache in one silent pass, publish
        it and reopen it, keeping the plan position. Parsing is
        deterministic, so the rebuilt blocks are the lost ones, byte for
        byte."""
        if corruption:
            _resilience.record_event("cache_corruptions")
            _resilience.record_event("cache_rebuilds")
        self._drop_reader()  # releases the reader's pin first
        _bc._artifact_store(self.cache_file).discard(self.cache_file)
        self._abort_writer()
        base = self.base
        base.before_first()
        writer = _bc.BlockCacheWriter(self.cache_file, signature=self._signature)
        try:
            while True:
                block = base.next_block()
                if block is None:
                    break
                self._tee_block(writer, block, block.resume_state)
            writer.finish()
        except BaseException:
            writer.abort()
            raise
        pos = self._pos  # _open_reader rewinds
        check(self._open_reader(),
              f"block cache {self.cache_file}: rebuild did not publish a readable cache")
        self._pos = pos

    def _heal_corruption(self) -> None:
        """Warm block ``_pos`` failed its crc32: drop the cache, re-parse
        the source from its start (the blocks already delivered this epoch
        are shadow-written again, not delivered), rewrite the whole cache,
        and deliver from the broken block on."""
        _resilience.record_event("cache_corruptions")
        _resilience.record_event("cache_rebuilds")
        self._drop_reader()  # releases the reader's pin first
        _bc._artifact_store(self.cache_file).discard(self.cache_file)
        self._abort_writer()
        self._mode = "cold"
        self._shadow = True
        self._skip = self._pos
        self._pos = 0
        self._cold_seen = 0  # counts through the skipped prefix again
        self.base.before_first()

    def _next_cold(self) -> Optional[RowBlock]:
        while True:
            block = self.base.next_block()
            if block is None:
                writer, self._writer = self._writer, None
                if writer is not None:
                    t0 = get_time()
                    writer.finish()  # fsync + publish
                    dt = get_time() - t0
                    self.cache_write_seconds += dt
                    _telemetry.record_span("cache_write", t0, dt)
                return None
            annot = block.resume_state
            writer = self._ensure_writer()
            if writer is not None:
                t0 = get_time()
                self._tee_block(writer, block, annot)  # records its cache_write span
                self.cache_write_seconds += get_time() - t0
            seen = self._cold_seen
            self._cold_seen += 1
            if self._skip > 0:
                self._skip -= 1
                continue
            if self._num_hosts > 1 and seen % self._num_hosts != self._host_id:
                # the pod-sharded cold pass writes every block and delivers
                # round-robin, so the hosts' cold streams are disjoint too
                continue
            if self._num_hosts > 1 and annot is not None:
                # the state must carry the shard cursor
                block.resume_state = dict(self._plan_annot(0), cold=annot, seen=seen + 1)
            self._delivered += 1
            return block

    def before_first(self) -> None:
        self._abort_writer()  # an interrupted cold pass cannot publish
        self._quiesce_plan_pool()
        if self._delivered or self._pos or self._cold_seen:
            # a pass ran: this rewind starts the next epoch
            self._epoch += 1
        self._plan = None
        self._seq_restore = False
        self._cold_seen = 0
        self._skip = 0
        self._delivered = 0
        if self._mode == "warm":
            self._pos = 0
            return
        if self._open_reader():
            return  # the finished cold pass published: serve warm
        self._shadow = True
        self.base.before_first()

    # ---------------- checkpoints ----------------

    def _plan_annot(self, pos: int) -> dict:
        return _epoch.plan_state_dict(self._seed, self._window, self._epoch, pos,
                                      self._host_id, self._num_hosts)

    def state_dict(self) -> dict:
        if self._mode == "warm":
            if self._plan_armed and not self._seq_restore:
                return self._plan_annot(self._pos)
            return {"kind": "block_cache", "block": self._pos}
        base_state = self.base.state_dict()
        if self._num_hosts > 1:
            # the sharded cold pass's filter cursor rides along
            return dict(self._plan_annot(0), cold=base_state, seen=self._cold_seen)
        return base_state

    def _find_block(self, state: dict) -> Optional[int]:
        """The block to resume at for a parser-chain state: the stored
        annotations mark the position just after each block, so a match at
        block i resumes at i + 1."""
        if not state.get("chunks") and not state.get("blocks"):
            return 0  # an epoch-start state
        key = annot_key(state)
        reader = self._reader
        for i in range(reader.num_blocks):
            annot = reader.resume(i)
            if annot is not None and annot_key(annot) == key:
                return i + 1
        return None

    def _set_warm_pos(self, n: int) -> None:
        self._pos = n
        self._delivered = n

    def load_state(self, state: dict) -> None:
        kind = state.get("kind")
        if kind == "epoch_plan":
            self._load_plan_state(state)
            return
        if self._plan_armed:
            self._load_legacy_into_plan(state)
            return
        if kind == "block_cache":
            n = int(state["block"])
            self._abort_writer()
            if self._mode == "warm" or self._open_reader():
                self._set_warm_pos(n)
                return
            # the cache is gone: rebuild it from the source, shadow-writing
            # the skipped prefix, so the rebuilt cache is whole
            self._shadow = True
            self._skip = n
            self._delivered = n
            self.base.before_first()
            return
        if self._mode == "warm":
            # a delivered count maps 1:1 onto block indices
            idx = int(state["blocks"]) if kind == "blocks" else self._find_block(state)
            if idx is not None:
                self._set_warm_pos(idx)
                return
            # an annotation this cache does not know: the parser chain
            self._drop_reader()
            self._mode = "cold"
        # a cold seek mid-stream cannot write a whole cache: no shadow
        # writing until the next epoch
        self._abort_writer()
        self._shadow = False
        self._skip = 0
        self.base.load_state(state)
        self._delivered = int(state.get("blocks", state.get("chunks", 0)) or 0)

    def _load_plan_state(self, state: dict) -> None:
        """Restore a ``kind="epoch_plan"`` state, adopting its plan identity
        (seed, window, epoch, sharding) whole: the state is the stream
        position, even in a pipeline built with other knobs."""
        check(state.get("unit") in (None, "block"),
              "epoch_plan state over snapshot BATCHES (unit='batch') "
              "cannot restore into the block cache's block stream — "
              "restore it into a snapshot-armed DeviceIter "
              "(docs/data.md snapshot section)")
        self._abort_writer()
        self._quiesce_plan_pool()
        seed = state.get("seed")
        self._seed = None if seed is None else int(seed)
        self._window = int(state.get("window", 0))
        self._host_id = int(state.get("host_id", 0))
        self._num_hosts = int(state.get("num_hosts", 1))
        self._epoch = int(state.get("epoch", 0))
        self._plan = None
        self._skip = 0
        if "cold" in state:
            # a sharded cold pass's state: the base annotation under
            # 'cold', the shard cursor under 'seen'
            cold, seen = state["cold"], int(state.get("seen", 0))
            if self._mode == "warm" or self._open_reader():
                idx = self._find_block(cold) if cold is not None else None
                if idx is not None:
                    # the published cache holds the cold stream: serve its
                    # rest sequentially through the shard filter
                    self._seq_restore = True
                    self._pos = idx
                    self._cold_seen = idx
                    self._delivered = max(0, -(-(idx - self._host_id) // self._num_hosts))
                    return
                self._drop_reader()
                self._mode = "cold"
            # resume the sharded cold pass itself (no whole cache to publish)
            self._seq_restore = False
            self._shadow = False
            self._mode = "cold"
            if cold is not None:
                self.base.load_state(cold)
            self._cold_seen = seen
            self._delivered = max(0, -(-(seen - self._host_id) // self._num_hosts))
            return
        target = int(state["pos"])
        self._seq_restore = False
        if self._mode != "warm" and not self._open_reader():
            # the cache is gone: one silent rebuild, then the plan position
            self._rebuild_cache()
        self._pos = target
        self._delivered = target
        self._cold_seen = 0

    def _load_legacy_into_plan(self, state: dict) -> None:
        """A sequential-order state (``block_cache``, ``blocks``, or a
        parser-chain ``split``) restored into a plan pipeline: its position
        exists in the sequential stream only, so the rest of this epoch
        serves sequentially, and the plan resumes at the next
        :meth:`before_first`."""
        kind = state.get("kind")
        self._abort_writer()
        self._quiesce_plan_pool()
        self._skip = 0
        if self._mode != "warm" and not self._open_reader():
            if kind in ("block_cache", "blocks"):
                self._rebuild_cache()  # cache positions exist in a cache only
            else:
                self._legacy_cold_seek(state)
                return
        if kind == "block_cache":
            idx: Optional[int] = int(state["block"])
        elif kind == "blocks":
            idx = int(state["blocks"])
        else:
            idx = self._find_block(state)
        if idx is None:
            # an annotation this cache does not know: the parser chain
            self._drop_reader()
            self._mode = "cold"
            self._legacy_cold_seek(state)
            return
        self._seq_restore = True
        self._cold_seen = idx
        self._set_warm_pos(idx)

    def _legacy_cold_seek(self, state: dict) -> None:
        self._seq_restore = False
        self._shadow = False
        self.base.load_state(state)
        n = int(state.get("blocks", state.get("chunks", 0)) or 0)
        self._cold_seen = n
        self._delivered = n

    # ---------------- metrics ----------------

    def stage_seconds(self) -> Dict[str, float]:
        """The base chain's ``{read, parse}`` seconds (0 before a cold pass
        built it) and ``cache_read``, the warm block reads."""
        out = {"read": 0.0, "parse": 0.0}
        fn = getattr(self._base, "stage_seconds", None)  # the native reader has none
        if fn is not None:
            out.update(fn())
        out["cache_read"] = self._cache_read_seconds
        return out

    def parallel_stats(self) -> Optional[dict]:
        """The base chain's parse fan-out stats on a cold pass, else None."""
        fn = getattr(self._base, "parallel_stats", None)
        return fn() if self._mode != "warm" and fn is not None else None

    def resize_parse_workers(self, num_workers: int) -> bool:
        """The autotuner's parse knob, passed to the base chain: False until
        a cold pass built it (warm epochs parse nothing)."""
        fn = getattr(self._base, "resize_parse_workers", None)
        return bool(fn(num_workers)) if fn is not None else False

    def resize_plan_read_workers(self, num_workers: int) -> bool:
        """The plan read pool's width, live (its window ``2 * n``) and for
        every pool built after; plan order holds either way. True."""
        n = max(1, int(num_workers))
        self.plan_read_workers = n
        if self._plan_pool is not None:
            self._plan_pool.resize(n)
            self._plan_pool.set_max_ahead(2 * n)
        return True

    @property
    def bytes_read(self) -> int:
        """The base parser's source bytes (0 before any cold pass built it)
        plus the cache bytes served."""
        cold = self._base.bytes_read if self._base is not None else 0
        return cold + self._bytes

    def close(self) -> None:
        self._abort_writer()
        self._quiesce_plan_pool()
        self._drop_reader()
        if self._base is not None:
            self._base.close()


def _resolve_block_cache(spec: URISpec, part_index: int, num_parts: int,
                         explicit: Optional[str]) -> Optional[str]:
    """The block cache's path: the explicit ``block_cache=`` knob, then the
    ``#blockcache=<path>`` fragment, then the ``DMLC_TPU_BLOCK_CACHE``
    directory (a name from a sha1 of the URI and its arguments); a part of
    several gets the ``.split<N>.part<K>`` suffix."""
    path = explicit if explicit is not None else spec.block_cache
    if path is None:
        env_dir = _knobs.block_cache_dir()
        if env_dir:
            key_src = spec.uri + "?" + "&".join(
                f"{k}={v}" for k, v in sorted(spec.args.items()))
            key = hashlib.sha1(key_src.encode()).hexdigest()[:16]
            path = os.path.join(env_dir, f"{key}.blockcache")
    if path is None:
        return None
    if num_parts != 1:
        path = f"{path}.split{num_parts}.part{part_index}"
    return path


def _parallel_chunk_source(uri: str, part_index: int, num_parts: int,
                           **split_kw) -> InputSplit:
    """The chunk source under the parse fan-out: a plain single local file
    gets the zero-copy :class:`~dmlc_tpu_torch.io.MmapLineSplit`, whose
    chunks on one file are the stream's, so per-chunk semantics
    (``indexing_mode = -1``, per-chunk checks) cannot differ between worker
    counts. Several files, a chunk cache and the split decorators keep the
    standard split stack (:func:`create_input_split`), whose chunks are
    the one-worker chain's."""
    plain = ("#" not in uri
             and not any(split_kw.get(k) for k in
                         ("shuffle", "num_shuffle_parts", "index_uri", "recurse_directories")))
    if plain and uri.split("?", 1)[0] != "stdin":
        try:
            split = create_mmap_text_split(
                uri, part_index, num_parts,
                chunk_bytes=split_kw.get("chunk_bytes", DEFAULT_CHUNK_BYTES))
            if len(split.files) == 1:
                return split
            split.close()  # several files: a join changes the chunk grouping
        except (DMLCError, OSError, ValueError):
            pass  # not mappable: the stream stack serves it
    return create_input_split(uri, part_index, num_parts, "text", threaded=True, **split_kw)


def _make_text_parser(cls):
    """The registry entry of a text format, with the JAX package's
    signature (``index_dtype`` is always ``np.uint64`` here):
    ``parse_workers > 1`` under ``threaded`` builds the fan-out, else the
    one-lane chain over :func:`create_input_split` (a
    :class:`~dmlc_tpu_torch.io.ThreadedInputSplit` under a
    :class:`ThreadedParser`), or the bare parser over the bare split
    without ``threaded``. ``split_kw`` are :func:`create_input_split`'s
    keywords."""
    def factory(uri: str, args: dict, part_index: int, num_parts: int, index_dtype,
                threaded: bool, parse_workers: Optional[int] = None, **split_kw) -> Parser:
        workers = _knobs.resolve("parse_workers", parse_workers)
        if threaded and workers > 1:
            source = _parallel_chunk_source(uri, part_index, num_parts, **split_kw)
            return ParallelTextParser(cls(source, args), num_workers=workers)
        source = create_input_split(uri, part_index, num_parts, "text", threaded=threaded,
                                    **split_kw)
        base = cls(source, args)
        return ThreadedParser(base) if threaded else base
    return factory


# the formats create_parser dispatches, the JAX package's registry of kind
# "parser": a format registered here reaches create_parser (its factory is
# called as ``body(uri, args, part_index, num_parts, index_dtype, threaded,
# parse_workers=, **split_kw)``)
PARSER_REGISTRY: Registry = Registry.get("parser")

# csv is registered unthreaded in the reference (data.cc:51-60 wraps libsvm
# and libfm only); the JAX package threads it too, and so does the port
PARSER_REGISTRY.register("libsvm", "libsvm text format")(_make_text_parser(LibSVMParser))
PARSER_REGISTRY.register("libfm", "libfm field:index:value format")(
    _make_text_parser(LibFMParser))
PARSER_REGISTRY.register("csv", "dense csv format")(_make_text_parser(CSVParser))


def _pin_python_scanner(parser: Parser) -> None:
    """``engine="python"``: the numpy scanner all the way down, under every
    wrapper of the registry stack (a stack that is not text is left as
    it is)."""
    base = parser
    while not isinstance(base, TextParserBase):
        base = getattr(base, "base", None)
        if base is None:
            return
    base._native = False


# the intra-block row-shuffle window the legacy ``shuffle=True`` split
# argument maps onto when a block cache serves the epoch (the JAX value)
LEGACY_SHUFFLE_WINDOW = 4096


def _build_uncached(uri: str, spec: URISpec, type_: str, part_index: int,
                    num_parts: int, threaded: bool, parse_workers: Optional[int],
                    engine: str, **split_kw) -> Parser:
    """The JAX package's engine chain (``_create_parser_uncached``) over a
    resolved engine: ``auto`` or ``native`` take the fused native reader
    for a plain local corpus (unless ``DMLC_TPU_NO_NATIVE_READER`` is set),
    and everything else the registry stack; ``python`` pins the numpy
    scanner under every wrapper of that stack. A ``#cachefile`` fragment
    stays on ``uri``: it keeps the corpus off the fused reader and arms the
    chunk cache at the split layer."""
    split_uri = spec.uri
    if "#" in uri:
        # create_input_split derives the partition-qualified cache name
        split_uri = f"{spec.uri}#{uri.split('#', 1)[1]}"
    if engine == "native-batch":
        from dmlc_tpu_torch.data import batch_parser as _bp

        if _bp.batch_engine_eligible(type_, np.uint64, spec.args):
            return _bp.create_batch_parser(split_uri, spec.args, part_index, num_parts, type_,
                                           threaded=threaded, parse_workers=parse_workers,
                                           **split_kw)
        # the batch kernel cannot serve this configuration (format, dtype,
        # no native library): the Python engine, loudly, so the knob never
        # names a path that did not run
        get_logger().warning(
            "engine=native-batch unavailable for format=%r index_dtype=%s "
            "(toolchain/format/dtype); using the Python engine",
            type_, np.dtype(np.uint64).str)
    if (engine in ("auto", "native")
            and os.environ.get("DMLC_TPU_NO_NATIVE_READER", "0") in ("", "0")):
        from dmlc_tpu_torch.data import native_parser as _native_parser

        chunk_bytes = split_kw.get("chunk_bytes", DEFAULT_CHUNK_BYTES)
        if _native_parser.native_reader_eligible(uri, type_, threaded, split_kw):
            try:
                return _native_parser.NativeStreamParser(
                    spec.uri, spec.args, part_index, num_parts, type_,
                    chunk_bytes=chunk_bytes)
            except DMLCError:
                pass  # e.g. a csv dtype the native scanner lacks: the registry stack
        elif _native_parser.native_feed_eligible(uri, type_, threaded, split_kw):
            # another registered filesystem: its bytes fed to the C++ chunk parser
            try:
                return _native_parser.NativeFeedParser(
                    spec.uri, spec.args, part_index, num_parts, type_,
                    chunk_bytes=chunk_bytes)
            except DMLCError:
                pass  # the registry stack serves it
    if engine == "native":
        get_logger().warning(
            "engine=native unavailable for uri=%r format=%r "
            "(URI/threading outside the fused reader's eligibility, "
            "DMLC_TPU_NO_NATIVE_READER, or toolchain); using the Python "
            "engine", uri, type_)
    parser = _format_entry(type_).body(split_uri, spec.args, part_index, num_parts, np.uint64,
                                       threaded, parse_workers=parse_workers, **split_kw)
    if engine == "python":
        _pin_python_scanner(parser)
    return parser


def _format_entry(type_: str):
    """``type_``'s entry in :data:`PARSER_REGISTRY`; an unknown format
    raises with the registered names, in the JAX package's words."""
    entry = PARSER_REGISTRY.find(type_)
    if entry is None:
        raise DMLCError(
            f"unknown parser format {type_!r}; known: {list(PARSER_REGISTRY.list_names())}")
    return entry


# create_input_split's keywords, which create_parser passes down
_SPLIT_KEYWORDS = ("index_uri", "shuffle", "seed", "batch_size", "recurse_directories",
                   "num_shuffle_parts", "chunk_bytes")


def create_parser(uri: str, part_index: int = 0, num_parts: int = 1,
                  type_: str = "auto", index_dtype=np.uint64, threaded: bool = True,
                  *, parse_workers: Optional[int] = None, engine: Optional[str] = None,
                  snapshot: Optional[str] = None, block_cache: Optional[str] = None,
                  shuffle_seed: Optional[int] = None, shuffle_window: int = 0,
                  pod_sharding=False, service: Optional[str] = None,
                  service_job: Optional[str] = None, **split_kw) -> Parser:
    """Parser factory — analog of dmlc::Parser::Create (src/data.cc:62-85).

    The positional parameters are the JAX package's: ``type_`` is
    ``libsvm``, ``csv``, ``libfm`` or another entry of
    :data:`PARSER_REGISTRY` (its factory builds the parser), and
    ``'auto'`` resolves from the URI's ``format=`` argument and defaults
    to libsvm; ``index_dtype`` must be
    ``np.uint64`` (the blocks' index type; another raises). URI arguments
    (``?label_column=0&delimiter=;``, ``?indexing_mode=1``) flow into the
    format's parameter struct.

    The engine (the JAX package's chain): ``engine``, else a ``?engine=``
    URI argument, else ``DMLC_TPU_PARSE_ENGINE``, else ``"auto"``
    (:func:`dmlc_tpu_torch.utils.knobs.parse_engine`; a typo raises).
    ``auto`` and ``native`` return the fused native reader
    (:class:`~dmlc_tpu_torch.data.native_parser.NativeStreamParser`) for a
    threaded parse of a plain local libsvm, csv or libfm file whose
    options it serves, and the chunk feeder
    (:class:`~dmlc_tpu_torch.data.native_parser.NativeFeedParser`) for the
    same on another registered filesystem (``mem://`` or a cloud store), unless
    ``DMLC_TPU_NO_NATIVE_READER`` is set to other than ``0``; ``native``
    warns where it cannot. ``native-batch`` returns the chunk-batch engine
    (:class:`~dmlc_tpu_torch.data.batch_parser.NativeBatchParser`) over the
    registry stack's chunk sources, and warns and takes the registry stack
    for a configuration it cannot serve (a non-float32 csv), as the JAX
    package does. ``python`` takes the registry stack on the numpy scanner.

    The registry stack: ``threaded`` parses ahead of the consumer:
    on ``parse_workers`` threads (:class:`ParallelTextParser`; None reads
    ``DMLC_TPU_PARSE_WORKERS``, else ``min(4, cpus)``), over a zero-copy
    :class:`~dmlc_tpu_torch.io.MmapLineSplit` for a single local file, or
    with ``parse_workers=1`` on one thread (:class:`ThreadedParser` over a
    :class:`~dmlc_tpu_torch.io.ThreadedInputSplit` over a
    :class:`~dmlc_tpu_torch.io.LineSplitter`, as in the JAX package);
    ``threaded=False`` returns the bare parser. The blocks are the same at
    every worker count, and so are the states above one worker. A state
    marks the same position at every count and restores in either split,
    but the one-thread chain's carries the stream split's read-ahead
    ``overflow``, so its JSON differs. The keywords after ``threaded``
    are keyword-only.

    ``split_kw`` are :func:`~dmlc_tpu_torch.io.input_split.create_input_split`'s
    keywords, the JAX package's: ``chunk_bytes`` (the split's chunk size,
    at least 4096, which sets the blocks), ``shuffle`` / ``seed`` /
    ``num_shuffle_parts`` (the chunk-shuffle decorator), ``index_uri``,
    ``batch_size`` and ``recurse_directories``; they enter the cache and
    snapshot signature as in the JAX package. A ``#cachefile`` fragment
    (``path#cache``, ``.split<N>.part<K>`` for one of several parts) arms
    the chunk cache at the split layer
    (:mod:`dmlc_tpu_torch.io.cached_split`) and keeps the corpus off the
    fused native reader: the first epoch writes it, later epochs read only
    it.

    ``block_cache`` (else a ``#blockcache=<path>`` fragment, else the
    ``DMLC_TPU_BLOCK_CACHE`` directory) returns a :class:`BlockCacheIter`
    over the chain: the first epoch writes the parsed blocks to the cache,
    later epochs serve them from it. ``shuffle_seed`` / ``shuffle_window``
    arm the epoch planner on it (a seeded block permutation each warm
    epoch, rows shuffled within windows of ``shuffle_window``; 0 shuffles
    blocks only), and ``pod_sharding`` keeps this host's disjoint shard of
    each epoch: ``True`` resolves ``(host_id, num_hosts)`` with
    :func:`dmlc_tpu_torch.parallel.distributed.pod_identity`, or pass the
    tuple. The plan knobs need a cache and stay out of its signature, so
    one cache serves every ``(seed, window, sharding)``.

    ``snapshot`` (else a ``#snapshot=<path>`` fragment) arms the snapshot
    store: the parser carries
    ``snapshot_path`` (suffixed ``.split<N>.part<K>`` for one of several
    parts) and ``snapshot_signature``, the source key a snapshot is bound
    to, which a :class:`~dmlc_tpu_torch.data.device.DeviceIter` over it
    picks up. It does not combine with ``shuffle_seed``: shuffled snapshot
    epochs come from ``DeviceIter``'s ``snapshot_shuffle_seed``.

    The legacy shuffle arguments: without a block cache, ``shuffle`` /
    ``num_shuffle_parts`` / ``seed`` build the split layer's
    :class:`~dmlc_tpu_torch.io.input_split.ShuffledInputSplit`; with one,
    they map onto the epoch plan as in the JAX package, with its
    ``DeprecationWarning``: ``shuffle_seed`` defaults to ``seed``,
    ``shuffle=True`` sets ``shuffle_window`` to
    :data:`LEGACY_SHUFFLE_WINDOW` where it was 0, and the three arguments
    leave the cache signature (one cache serves every seed).

    The signatures equal the JAX package's for the same corpus, format
    and arguments (the engine and worker knobs stay out of them), so a
    cache or a snapshot written by either package opens in the other.

    ``service`` (else a ``#service=<host:port>`` fragment) names a data
    service dispatcher: the blocks are parsed by its worker fleet and the
    parser returned is the :class:`~dmlc_tpu_torch.service.client.
    ServiceParser`, bound to the job ``service_job`` (else a ``?job=``
    argument, else the default job). The dispatcher owns the dataset's
    spec, partitioning and plan, so a client-side ``part_index`` /
    ``num_parts``, ``shuffle_seed`` / ``shuffle_window`` / ``pod_sharding``
    or ``snapshot=`` raises, with the JAX package's messages; every other
    argument is ignored.
    """
    unknown = sorted(set(split_kw) - set(_SPLIT_KEYWORDS))
    if unknown:
        raise TypeError(f"create_parser() got unexpected keyword arguments {unknown}")
    spec = URISpec(uri, part_index, num_parts)
    if service is None:
        service = spec.service
    if service is not None:
        # the dispatcher owns partitioning: handing every rank the whole
        # dataset would duplicate training data
        check(part_index == 0 and num_parts == 1,
              "create_parser(service=...): client-side part_index/"
              "num_parts are not supported — the dispatcher owns the "
              "dataset's partitioning (docs/service.md)")
        # and the epoch plan: dropping the knobs would hand back unshuffled
        # epochs the caller asked to shuffle
        check(shuffle_seed is None and shuffle_window == 0
              and not pod_sharding,
              "create_parser(service=...): client-side shuffle_seed/"
              "shuffle_window/pod_sharding are not supported — the "
              "dispatcher owns the dataset's plan (Dispatcher(plan=...), "
              "docs/service.md plan distribution)")
        check(snapshot is None,
              "create_parser(service=...): client-side snapshot= is not "
              "supported — the dispatcher decides whether the fleet "
              "ships device-layout snapshot frames "
              "(Dispatcher(snapshot=...), docs/service.md)")
        from dmlc_tpu_torch.service.client import ServiceParser
        from dmlc_tpu_torch.service.dispatcher import DEFAULT_JOB

        job = (service_job if service_job is not None
               else spec.args.get("job", DEFAULT_JOB))
        return ServiceParser(service, job=job)
    if type_ == "auto":
        type_ = spec.args.get("format", "libsvm")
    _format_entry(type_)
    if np.dtype(index_dtype) != np.dtype(np.uint64):
        raise DMLCError(f"index_dtype {np.dtype(index_dtype)}: dmlc_tpu_torch "
                        "parses uint64 indices only")
    engine = _knobs.parse_engine(engine if engine is not None else spec.args.get("engine"))
    bc_path = _resolve_block_cache(spec, part_index, num_parts, block_cache)
    if snapshot is None:
        snapshot = spec.snapshot
    if snapshot is not None and num_parts != 1:
        snapshot = f"{snapshot}.split{num_parts}.part{part_index}"
    check(snapshot is None or shuffle_seed is None,
          "snapshot= cannot combine with shuffle_seed= (the snapshot "
          "freezes one epoch's batch order) — use DeviceIter's "
          "snapshot_shuffle_seed for shuffled snapshot epochs "
          "(docs/data.md)")
    if spec.block_cache is not None or spec.snapshot is not None:
        # cache/snapshot routing, not a chunk cache: the engines see a plain URI
        uri = uri.split("#", 1)[0]
    if bc_path is not None and (split_kw.get("shuffle") or split_kw.get("num_shuffle_parts")):
        # the JAX package's one-release mapping of the split layer's shuffle
        # arguments onto the epoch plan that orders the cached blocks
        warnings.warn(
            "block_cache + shuffle decorator args (shuffle/"
            "num_shuffle_parts) now map onto the shuffle-native epoch "
            "plan; pass shuffle_seed/shuffle_window directly — this "
            "mapping will be removed in the next release (docs/data.md)",
            DeprecationWarning, stacklevel=2)
        if shuffle_seed is None:
            shuffle_seed = int(split_kw.get("seed", 0) or 0)
        if split_kw.pop("shuffle", None) and shuffle_window == 0:
            shuffle_window = LEGACY_SHUFFLE_WINDOW
        split_kw.pop("num_shuffle_parts", None)
        # the seed lives in the plan now, which stays out of the signature
        split_kw.pop("seed", None)
        get_logger().warning(
            "create_parser: mapping legacy shuffle decorator args onto "
            "the epoch plan (effective shuffle_seed=%s, shuffle_window=%s)",
            shuffle_seed, shuffle_window)
    # the engine is left out of the signature (every engine emits the same
    # blocks from the same chunks); the split layer's config is in it
    signature = _bc.source_signature(
        spec.uri, part_index, num_parts, format=type_,
        args={k: v for k, v in spec.args.items() if k != "engine"},
        index_dtype=np.dtype(np.uint64).str,
        chunk_bytes=int(split_kw.get("chunk_bytes", DEFAULT_CHUNK_BYTES)),
        split={k: v for k, v in sorted(split_kw.items()) if k != "chunk_bytes"})

    def build() -> Parser:
        return _build_uncached(uri, spec, type_, part_index, num_parts, threaded,
                               parse_workers, engine, **split_kw)

    if bc_path is None:
        check(shuffle_seed is None and shuffle_window == 0 and not pod_sharding,
              "shuffle_seed/shuffle_window/pod_sharding require a "
              "block_cache: the epoch plan orders cached blocks "
              "(docs/data.md)")
        parser = build()
    else:
        check(shuffle_window == 0 or shuffle_seed is not None,
              "shuffle_window requires shuffle_seed: the row-shuffle rng is "
              "keyed by the seed, so a window alone would silently serve "
              "sequential epochs (docs/data.md)")
        host_id, num_hosts = 0, 1
        if pod_sharding:
            if isinstance(pod_sharding, (tuple, list)):
                host_id, num_hosts = int(pod_sharding[0]), int(pod_sharding[1])
            else:
                host_id, num_hosts = pod_identity()
            check(num_parts == 1,
                  "pod_sharding shards the one logical epoch at the cache "
                  "block level; combining it with num_parts partitioning "
                  "would double-shard — use one or the other (docs/data.md)")
        parser = BlockCacheIter(build, bc_path, signature=signature,
                                shuffle_seed=shuffle_seed, shuffle_window=shuffle_window,
                                host_id=host_id, num_hosts=num_hosts)
        # the width the lazily built base will use: the autotuner seeds its
        # parse knob from it before a cold pass builds the parser
        parser.parse_workers_hint = _knobs.resolve("parse_workers", parse_workers)
    if snapshot is not None:
        parser.snapshot_path = snapshot
        parser.snapshot_signature = signature
    return parser
