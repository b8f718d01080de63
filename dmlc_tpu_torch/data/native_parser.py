"""The fused native reader: the whole read -> chunk -> parse pipeline in C++
(``native/src/reader.cc``), one pull per parsed block with the interpreter
lock released.

Own copy of the JAX package's ``data/native_parser.py``
(:class:`NativeStreamParser`, :class:`NativeFeedParser`,
:func:`list_partition_files`, :func:`native_reader_eligible`,
:func:`native_feed_eligible`). Where the reference stacks a threaded
input split, a parse-ahead thread and per-chunk parse threads
(src/io/threaded_input_split.h, src/data/parser.h:70-126), this class hands
the same pipeline to the native core: the blocks are the registry stack's,
chunk for chunk.

``create_parser`` routes plain local libsvm, csv and libfm corpora here
(:func:`native_reader_eligible`), and plain corpora on another registered
filesystem to :class:`NativeFeedParser`, whose feed thread pushes the
partition's bytes into the same C++ pipeline (:func:`native_feed_eligible`);
decorated URIs and ``engine=python`` take the registry stack. Two emits
move device-layout work into the C++ parse threads:

- ``set_emit_dense(num_col, batch_rows, dtype, pack_aux)``: :class:`DenseBlock`
  batches, repacked to exact ``[batch_rows, num_col]`` blocks (bfloat16 with
  ``dtype="bfloat16"``, label and weight as two trailing columns with
  ``pack_aux``);
- ``set_emit_coo(num_col, row_bucket, nnz_bucket, elide_unit, csr_wire)``:
  :class:`CooBlock` batches, one a chunk.

Checkpoints: a state is a block count (``kind="blocks"``, the JAX
package's, key for key); the native chunking is deterministic, so restoring
replays that many blocks.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from dmlc_tpu_torch import native
from dmlc_tpu_torch.data.parsers import (CSVParserParam, LibFMParserParam,
                                         LibSVMParserParam, Parser, _csv_skeleton,
                                         csv_cells_to_block, csv_cells_to_dense)
from dmlc_tpu_torch.data.row_block import CooBlock, DenseBlock, RowBlock
from dmlc_tpu_torch.io.filesystem import LocalFileSystem, get_filesystem
from dmlc_tpu_torch.io.input_split import DEFAULT_CHUNK_BYTES, LineSplitter
from dmlc_tpu_torch.io.uri import URI
from dmlc_tpu_torch.utils import telemetry as _telemetry
from dmlc_tpu_torch.utils.check import DMLCError, check
from dmlc_tpu_torch.utils.timer import get_time


def list_partition_files(uri: str) -> Tuple[List[str], List[int]]:
    """A local URI (``;`` lists, directories) expanded to ``(paths,
    sizes)`` with the input split's matching rules."""
    check(isinstance(get_filesystem(uri), LocalFileSystem), "native reader requires local files")
    lister = LineSplitter(uri, None)  # the listing only: no partition
    try:
        return ([info.path.name for info in lister.files],
                [info.size for info in lister.files])
    finally:
        lister.close()


class NativeStreamParser(Parser):
    """Parser over :class:`dmlc_tpu_torch.native.Reader`: the native reader
    owns partitioning (byte ranges moved to record heads), chunking and the
    threaded parse; this class wraps its buffers, with no copy, as
    :class:`RowBlock`, :class:`DenseBlock` or :class:`CooBlock`."""

    def __init__(self, uri: str, args: Optional[Dict[str, str]], part_index: int,
                 num_parts: int, fmt_name: str, index_dtype=np.uint64,
                 chunk_bytes: int = DEFAULT_CHUNK_BYTES):
        check(fmt_name in ("libsvm", "csv", "libfm"),
              f"native reader does not support format {fmt_name!r}")
        check(np.dtype(index_dtype) == np.dtype(np.uint64),
              f"index_dtype {np.dtype(index_dtype)}: dmlc_tpu_torch parses uint64 "
              "indices only")
        # the input split's partition checks: num_parts=0 would divide by
        # zero in the native byte range, and an out-of-range part would
        # silently yield an empty stream
        check(num_parts >= 1, f"num_parts must be >= 1, got {num_parts}")
        check(0 <= part_index < num_parts,
              f"part_index {part_index} out of range for {num_parts} parts")
        self.fmt_name = fmt_name
        self.chunk_bytes = chunk_bytes
        self.part_index = part_index
        self.num_parts = num_parts
        self.param = {"libsvm": LibSVMParserParam, "csv": CSVParserParam,
                      "libfm": LibFMParserParam}[fmt_name]()
        self.param.init(dict(args or {}), allow_unknown=True)
        if fmt_name == "csv":
            # the native csv scanner emits float32 cells only: this error
            # routes create_parser to the registry stack, which takes
            # int32/int64 and raises its own config errors
            check(self.param.dtype == "float32", "native reader: csv dtype must be float32")
            check(len(self.param.delimiter) == 1, "CSVParser: delimiter must be one char")
            check(self.param.label_column != self.param.weight_column
                  or self.param.label_column < 0,
                  "CSVParser: label_column must differ from weight_column")
        self._init_source(uri)
        self._reader = None
        self._emit_dense: Optional[int] = None
        self._emit_bf16 = False
        self._pack_aux = False
        self._emit_coo: Optional[int] = None
        self._coo_row_bucket = 0
        self._coo_nnz_bucket = 0
        self._coo_elide = False
        self._coo_csr_wire = False
        self._stall = 0.0
        self._blocks_out = 0  # delivered blocks, for a count resume
        self._batch_rows = 0
        self._bytes_base = 0  # bytes read under earlier partitions

    def _init_source(self, uri: str) -> None:
        """Resolve the byte source: here local files, listed with the
        split's matching rules (the native reader reads them itself)."""
        self.paths, self.sizes = list_partition_files(uri)

    @property
    def engine(self) -> str:
        """The engine in use: always ``native`` here."""
        return "native"

    # ---------------- configuration ----------------

    def set_emit_dense(self, num_col: int, batch_rows: int = 0, dtype: str = "float32",
                       pack_aux: bool = False) -> bool:
        """Emit :class:`DenseBlock` batches from the native dense scanner.
        With ``batch_rows`` the reader also repacks the rows into exact
        ``[batch_rows, num_col]`` blocks off the interpreter lock (the last
        may be short); ``dtype="bfloat16"`` makes that pass write bfloat16
        features; ``pack_aux`` (with ``batch_rows``) packs label and weight
        as two trailing columns, in bfloat16 too on a bfloat16 slab. Must
        come before the first pull; libfm has no dense form (False)."""
        if self._reader is not None or self.fmt_name == "libfm":
            return False
        self._emit_dense = int(num_col)
        self._batch_rows = int(batch_rows)
        self._emit_bf16 = dtype == "bfloat16"
        self._pack_aux = bool(pack_aux) and batch_rows > 0
        return True

    def set_emit_coo(self, num_col: int, row_bucket: int = 0, nnz_bucket: int = 0,
                     elide_unit: bool = False, csr_wire: bool = False) -> bool:
        """Emit :class:`CooBlock` batches from the native parse, one a
        chunk: int32 coordinates, rows and nnz padded up to bucket
        multiples, the values left out of an all-ones block with
        ``elide_unit``, and with ``csr_wire`` the columns plus ``row_ptr``
        in place of (row, col) pairs. Must come before the first pull; csv
        has no sparse form, and int32 coordinates need ``num_col + 1 <
        2**31`` (False otherwise)."""
        if (self._reader is not None or self.fmt_name == "csv"
                or int(num_col) + 1 >= (1 << 31)):
            return False
        self._emit_coo = int(num_col)
        self._coo_row_bucket = int(row_bucket)
        self._coo_nnz_bucket = int(nnz_bucket)
        self._coo_elide = bool(elide_unit)
        self._coo_csr_wire = bool(csr_wire)
        return True

    # ---------------- pipeline ----------------

    def _stream_config(self):
        """``(fmt, kwargs)`` of the native reader: the format and the
        repack policy."""
        if self._emit_coo is not None and self.fmt_name in ("libsvm", "libfm"):
            fmt = native.FMT_LIBFM_COO if self.fmt_name == "libfm" else native.FMT_LIBSVM_COO
        elif self.fmt_name == "libsvm":
            fmt = native.FMT_LIBSVM_DENSE if self._emit_dense is not None else native.FMT_LIBSVM
        elif self.fmt_name == "csv":
            # label or weight columns and no dense repack: the native merge
            # pass splits them out, so the RowBlock wrap copies nothing
            lc, wc = self.param.label_column, self.param.weight_column
            fmt = (native.FMT_CSV_SPLIT if self._emit_dense is None and (lc >= 0 or wc >= 0)
                   else native.FMT_CSV)
        else:
            fmt = native.FMT_LIBFM
        repack = (fmt == native.FMT_LIBSVM_DENSE
                  or (fmt == native.FMT_CSV and self._emit_dense is not None))
        coo = fmt in (native.FMT_LIBSVM_COO, native.FMT_LIBFM_COO)
        kwargs = dict(
            num_col=(self._emit_coo if coo else self._emit_dense) or 0,
            indexing_mode=getattr(self.param, "indexing_mode", 0),
            delimiter=getattr(self.param, "delimiter", ","),
            chunk_bytes=self.chunk_bytes,
            batch_rows=self._batch_rows if repack else 0,
            label_col=getattr(self.param, "label_column", -1),
            weight_col=getattr(self.param, "weight_column", -1),
            out_bf16=bool(repack and self._batch_rows and self._emit_bf16),
            row_bucket=self._coo_row_bucket if coo else 0,
            nnz_bucket=self._coo_nnz_bucket if coo else 0,
            elide_unit=self._coo_elide if coo else False,
            csr_wire=self._coo_csr_wire if coo else False,
            pack_aux=bool(repack and self._pack_aux))
        return fmt, kwargs

    def _ensure_reader(self):
        if self._reader is None:
            fmt, kwargs = self._stream_config()
            self._reader = native.Reader(self.paths, self.sizes, self.part_index,
                                         self.num_parts, fmt, **kwargs)
        return self._reader

    def next_block(self):
        reader = self._ensure_reader()
        t0 = get_time()
        out = reader.next()
        self._stall += get_time() - t0
        if out is None:
            return None
        self._blocks_out += 1
        fmt, data = out
        if fmt == native.FMT_LIBSVM_DENSE:
            x, label, weight, owner, packed = data
            return DenseBlock(x, label, weight, hold=owner, packed=packed)
        if fmt in (native.FMT_LIBSVM_COO, native.FMT_LIBFM_COO):
            return CooBlock(data["coords"], data["values"], data["label"], data["weight"],
                            data["n_rows"], data["nnz"], int(self._emit_coo),
                            hold=data["_owner"], row_ptr=data["row_ptr"])
        if fmt in (native.FMT_LIBSVM, native.FMT_LIBFM):
            return RowBlock(offset=data["offset"], label=data["label"], index=data["index"],
                            value=data["value"], weight=data["weight"], qid=data["qid"],
                            field=data["field"], hold=data["_owner"])
        if fmt == native.FMT_CSV_SPLIT:
            values, label, weight, n, owner = data
            index, offset = _csv_skeleton(n, values.shape[1])
            if label is None:
                label = np.zeros(n, np.float32)
            return RowBlock(offset=offset, label=label, index=index,
                            value=values.reshape(-1), weight=weight, hold=owner)
        cells, owner = data
        n, ncol = cells.shape
        if self._emit_dense is not None:
            return csv_cells_to_dense(cells, n, ncol, int(self._emit_dense),
                                      self.param.label_column, self.param.weight_column,
                                      owner)
        block = csv_cells_to_block(cells, n, ncol, self.param.label_column,
                                   self.param.weight_column)
        block.hold = owner
        return block

    def before_first(self) -> None:
        if self._reader is not None:
            self._reader.before_first()
        self._blocks_out = 0

    def reset_partition(self, part_index: int, num_parts: int) -> None:
        """Point at another partition: the file listing is kept, the native
        reader is rebuilt at the next pull; ``bytes_read`` keeps counting."""
        check(num_parts >= 1, f"num_parts must be >= 1, got {num_parts}")
        check(0 <= part_index < num_parts,
              f"part_index {part_index} out of range for {num_parts} parts")
        self._bytes_base = self.bytes_read
        self.close()
        self.part_index = part_index
        self.num_parts = num_parts
        self._blocks_out = 0

    # ---------------- checkpoints ----------------

    def state_dict(self) -> dict:
        """The resume point at a block boundary: the delivered block count
        (the native chunking is deterministic, so a count replays exactly)
        and the partition, re-applied first on a parser pointed elsewhere."""
        return {"kind": "blocks", "blocks": self._blocks_out,
                "part_index": self.part_index, "num_parts": self.num_parts}

    def load_state(self, state: dict) -> None:
        check(state.get("kind") == "blocks",
              f"native parser: incompatible resume state {state.get('kind')!r}")
        part, nparts = state.get("part_index"), state.get("num_parts")
        if (nparts is not None and part is not None
                and (part, nparts) != (self.part_index, self.num_parts)):
            self.reset_partition(int(part), int(nparts))
        n = int(state["blocks"])
        self.before_first()
        reader = self._ensure_reader()
        for _ in range(n):
            if reader.next() is None:
                break
        self._blocks_out = n

    @property
    def bytes_read(self) -> int:
        live = self._reader.bytes_read if self._reader is not None else 0
        return self._bytes_base + live

    @property
    def stall_seconds(self) -> float:
        """The consumer's wait on the native pipeline."""
        return self._stall

    @property
    def parse_workers(self) -> int:
        """The native reader's own parse threads (``DMLC_TPU_PARSE_THREADS``,
        :func:`dmlc_tpu_torch.native.default_nthread`); the registry stack's
        ``parse_workers`` knob does not apply."""
        return native.default_nthread()

    def parallel_stats(self) -> dict:
        """The fan-out sideband in :class:`ParallelTextParser`'s shape; the
        native core reports no per-thread busy time, so the efficiency is
        None."""
        return {"parse_workers": self.parse_workers, "parse_busy_seconds": None,
                "parse_span_seconds": None, "parse_parallelism_efficiency": None,
                "engine": "native"}

    def close(self) -> None:
        if self._reader is not None:
            self._reader.close()
            self._reader = None


def _native_eligible(uri: str, type_: str, threaded: bool, split_kw: Optional[Dict],
                     want_local: bool) -> bool:
    """The native routes' shared rule: a threaded parse of a plain text
    file (no ``#`` fragment, no ``engine=python``, none of the split
    layer's decorator keywords) with the native library built, on the
    local filesystem (``want_local``, the pull reader) or on another
    registered one (the chunk feeder)."""
    if not threaded or type_ not in ("libsvm", "csv", "libfm"):
        return False
    if "#" in uri or "engine=python" in uri:
        return False  # the chunk-cache decorator, or the explicit opt-out
    split_kw = split_kw or {}
    if any(split_kw.get(k) for k in ("shuffle", "num_shuffle_parts", "index_uri",
                                     "recurse_directories")):
        return False
    base = uri.split("?", 1)[0]
    if base == "stdin":
        return False
    try:
        fs = get_filesystem(URI(base))
    except DMLCError:
        return False
    if isinstance(fs, LocalFileSystem) != want_local:
        return False
    return native.available()


def native_reader_eligible(uri: str, type_: str, threaded: bool,
                           split_kw: Optional[Dict] = None) -> bool:
    """Whether ``create_parser`` can route ``uri`` to the fused reader: a
    plain local text file (:func:`_native_eligible`)."""
    return _native_eligible(uri, type_, threaded, split_kw, want_local=True)


class NativeFeedParser(NativeStreamParser):
    """A corpus on another registered filesystem (``mem://``) through the
    native pipeline: a feed thread reads this partition's bytes through the
    filesystem layer and pushes them into the C++ chunk feeder
    (``reader.cc``'s push mode, :class:`dmlc_tpu_torch.native.Feeder`),
    which owns the record-aligned chunking, the threaded parse and the
    batch repack, as the pull reader does for local files.

    The partition (byte range, move to a record head, newline at a text
    file's join) stays with the Python splitter, which speaks every
    filesystem; the feed thread streams exactly its bytes
    (``InputSplitBase._read``). An error in the feed thread reaches the
    consumer's :meth:`next_block` once the queued blocks have drained, as
    a ``DMLCError`` whose ``__cause__`` is the feed thread's exception, so
    the resilience classifier sees the original class."""

    FEED_CHUNK = 1 << 20

    def _init_source(self, uri: str) -> None:
        self.uri = uri
        self.paths = self.sizes = None
        self._feed_thread: Optional[threading.Thread] = None
        self._feed_exc: Optional[BaseException] = None  # the feed thread's error

    def _make_split(self) -> LineSplitter:
        return LineSplitter(self.uri, self.part_index, self.num_parts)

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
                # a failed read must not look like the end of the stream; the
                # native side carries only the message, so the exception
                # itself is kept for next_block's cause chain
                self._feed_exc = exc
                feeder.fail(f"feed failed: {exc}")
            finally:
                try:
                    split.close()
                except Exception:  # noqa: BLE001
                    pass

        # the feed thread runs under its creator's pipeline scope
        self._feed_thread = threading.Thread(target=_telemetry.scoped_target(run),
                                             name="dmlc-feed", daemon=True)
        self._feed_thread.start()

    def _stop_feed(self) -> None:
        if self._feed_thread is not None:
            if self._reader is not None:
                self._reader.abort()
            self._feed_thread.join()
            self._feed_thread = None

    def _ensure_reader(self):
        if self._reader is None:
            fmt, kwargs = self._stream_config()
            self._reader = native.Feeder(fmt, **kwargs)
            self._start_feed()
        return self._reader

    def next_block(self):
        try:
            return super().next_block()
        except DMLCError as exc:
            cause = self._feed_exc
            if cause is not None and exc.__cause__ is None:
                self._feed_exc = None
                raise exc from cause
            raise

    def before_first(self) -> None:
        self._feed_exc = None  # cleared before the next feed thread starts
        if self._reader is not None:
            self._stop_feed()
            if self._reader.error() is not None:
                # an error is sticky in the native pipeline: a failed feeder
                # cannot restart, so an epoch reset after a fault (a
                # pipeline restart) gets a new one
                self._reader.close()
                self._reader = None
                self._ensure_reader()
            else:
                self._reader.before_first()
                self._start_feed()
        self._blocks_out = 0

    def close(self) -> None:
        self._stop_feed()
        super().close()


def native_feed_eligible(uri: str, type_: str, threaded: bool,
                         split_kw: Optional[Dict] = None) -> bool:
    """Whether ``create_parser`` can route ``uri`` to the chunk feeder: a
    plain text file on a registered filesystem other than the local one
    (:func:`_native_eligible`)."""
    return _native_eligible(uri, type_, threaded, split_kw, want_local=False)
