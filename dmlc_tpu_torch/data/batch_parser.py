"""The chunk-batch native parse engine: ``engine="native-batch"``.

Own copy of the JAX package's ``data/batch_parser.py``. A whole chunk goes
to ``native/src/batch_parse.cc``, which scans the line boundaries with
SIMD (AVX2 / SSE2 / NEON by runtime dispatch, a scalar path otherwise),
parses the lines on C++ threads and writes the arrays straight into a
block-cache v1 (``DMLCBC01``) segment span: the segments in their order,
each start 64-byte aligned, with the zlib crc32 of the span. The
:class:`~dmlc_tpu_torch.data.row_block.RowBlock` returned wraps those
bytes with no copy, and the same bytes ride along as
:class:`EncodedSegments` on ``block.encoded``, so a block cache's cold
tee writes them with one file write and no Python re-encode
(:meth:`~dmlc_tpu_torch.io.block_cache.BlockCacheWriter.add_block_encoded`).

:class:`NativeBatchParser` is a chunk parser over an ordinary input split
(:class:`~dmlc_tpu_torch.data.parsers.TextParserBase`): it keeps the
``resume_state`` annotations, the ``stage_seconds()`` read / parse
split, ``state_dict`` / ``load_state``, and serves under
:class:`~dmlc_tpu_torch.data.parsers.ParallelTextParser` (chunks pulled
serially, parsed on the pool's workers with one native thread each). Its
blocks equal the Python engine's, and so do the block caches they make.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from dmlc_tpu_torch import native
from dmlc_tpu_torch.data.parsers import (CSVParserParam, LibFMParserParam,
                                         LibSVMParserParam, ParallelTextParser, Parser,
                                         TextParserBase, ThreadedParser,
                                         _parallel_chunk_source)
from dmlc_tpu_torch.data.row_block import RowBlock
from dmlc_tpu_torch.io.input_split import create_input_split
from dmlc_tpu_torch.utils import knobs as _knobs
from dmlc_tpu_torch.utils.check import DMLCError, check

#: the formats the batch kernel speaks (``native.BATCH_FMT``'s keys)
BATCH_FORMATS = ("libsvm", "csv", "libfm")


class EncodedSegments:
    """One chunk's block-cache v1 segment span, encoded natively.

    ``data`` is a uint8 view of the span (keep ``hold`` referenced while it
    lives), ``arrays`` maps a segment's name to ``[dtype_str, span_offset,
    nbytes]`` (the footer's schema, offsets from the span's start), and
    ``crc`` is the zlib crc32 of ``data``: the block's integrity word in
    the cache footer."""

    __slots__ = ("data", "arrays", "crc", "rows", "num_col", "hold")

    def __init__(self, data, arrays: Dict[str, list], crc: int, rows: int, num_col: int,
                 hold):
        self.data = data
        self.arrays = arrays
        self.crc = crc
        self.rows = rows
        self.num_col = num_col
        self.hold = hold

    @property
    def nbytes(self) -> int:
        return int(self.data.nbytes)


class NativeBatchParser(TextParserBase):
    """A chunk at a time through the SIMD batch parser, each block backed
    by its segment span (``engine="native-batch"``). There is no numpy
    half: without the native library the factory never builds one."""

    def __init__(self, source, args: Optional[Dict[str, str]] = None,
                 fmt_name: str = "libsvm", index_dtype=np.uint64):
        check(fmt_name in BATCH_FORMATS,
              f"native-batch engine does not support format {fmt_name!r}")
        # the segments hold the cache's uint64 index layout
        check(np.dtype(index_dtype) == np.dtype(np.uint64),
              "native-batch engine emits the cache's uint64 index layout; "
              "pass index_dtype=uint64 or use engine='python'")
        check(native.available(), "native core unavailable")
        super().__init__(source)
        self.fmt_name = fmt_name
        self.param = {"libsvm": LibSVMParserParam, "csv": CSVParserParam,
                      "libfm": LibFMParserParam}[fmt_name]()
        self.param.init(dict(args or {}), allow_unknown=True)
        if fmt_name == "csv":
            # CSVParser's checks, so a bad configuration fails here and
            # not deep inside the C scanner
            check(self.param.dtype == "float32", "native-batch engine: csv dtype must be float32")
            check(len(self.param.delimiter) == 1, "CSVParser: delimiter must be one char")
            check(self.param.label_column != self.param.weight_column
                  or self.param.label_column < 0,
                  "CSVParser: label_column must differ from weight_column")

    @property
    def engine(self) -> str:
        """The engine in use: always ``native-batch`` here."""
        return "native-batch"

    def parse_chunk(self, chunk) -> RowBlock:
        out = native.parse_batch(
            chunk, self.fmt_name, nthread=self._parse_nthread,
            indexing_mode=getattr(self.param, "indexing_mode", 0),
            delimiter=getattr(self.param, "delimiter", ","),
            label_col=getattr(self.param, "label_column", -1),
            weight_col=getattr(self.param, "weight_column", -1))
        if out is None:  # the library went away mid-run: fail loudly
            raise DMLCError("native core unavailable")
        if out["rows"] == 0:
            return RowBlock(np.zeros(1, np.int64), np.empty(0, np.float32),
                            np.empty(0, np.uint64))
        owner = out["_owner"]
        block = RowBlock.from_segments(out["segments"], hold=owner)
        block.encoded = EncodedSegments(out["data"], out["arrays"], out["crc"], out["rows"],
                                        out["num_col"], owner)
        return block


def batch_engine_eligible(type_: str, index_dtype, args: Dict) -> bool:
    """Whether the native-batch engine serves this configuration (format,
    index dtype, csv value dtype, the native library built)."""
    if type_ not in BATCH_FORMATS:
        return False
    if np.dtype(index_dtype) != np.dtype(np.uint64):
        return False
    if type_ == "csv" and (args or {}).get("dtype", "float32") != "float32":
        return False
    return native.available()


def create_batch_parser(uri: str, args: Optional[Dict[str, str]], part_index: int,
                        num_parts: int, type_: str, index_dtype=np.uint64,
                        threaded: bool = True, parse_workers: Optional[int] = None,
                        **split_kw) -> Parser:
    """The native-batch engine over the Python engine's chunk sources: a
    plain single local file gets the zero-copy mmap split under the
    :class:`ParallelTextParser` fan-out, everything else the stream split,
    so caches and checkpoints carry across the engines."""
    workers = _knobs.resolve("parse_workers", parse_workers)
    if threaded and workers > 1:
        source = _parallel_chunk_source(uri, part_index, num_parts, **split_kw)
        return ParallelTextParser(NativeBatchParser(source, args, type_, index_dtype),
                                  num_workers=workers)
    source = create_input_split(uri, part_index, num_parts, "text", threaded=threaded,
                                **split_kw)
    base = NativeBatchParser(source, args, type_, index_dtype)
    return ThreadedParser(base) if threaded else base
