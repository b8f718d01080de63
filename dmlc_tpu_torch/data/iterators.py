"""Multi-pass row-block iterators over parsed datasets.

Own copy of the JAX package's ``data/iterators.py``: the equivalent of
reference RowBlockIter (data.h:254-274) with its two implementations,
:class:`BasicRowIter` (in memory, src/data/basic_row_iter.h) and
:class:`DiskRowIter` (a page cache on disk, src/data/disk_row_iter.h),
and the ``#cachefile`` dispatch of src/data.cc:88-107
(:func:`create_row_block_iter`). A :class:`RowBlockIter` is a block
source a :class:`~dmlc_tpu_torch.data.device.DeviceIter` takes as it
takes a parser (``next_block`` / ``before_first``).

The page cache is the JAX package's file, byte for byte: the magic
``DMLCTPU-RBCACHE1``, ``num_col`` and the page table's offset as u64 LE,
then pages of at most :data:`CACHE_PAGE_BYTES` block bytes each (one
:meth:`~dmlc_tpu_torch.data.row_block.RowBlock.save`), then the page
count and the page offsets. It is written through
:func:`~dmlc_tpu_torch.io.stream.open_stream`, so a cache written by
either package serves in the other.
"""

from __future__ import annotations

import os
import struct
from typing import Iterator, List, Optional

import numpy as np

from dmlc_tpu_torch.data.autotune import ParseTierTuner, efficiency_window
from dmlc_tpu_torch.data.parsers import Parser, create_parser
from dmlc_tpu_torch.data.row_block import RowBlock, RowBlockContainer
from dmlc_tpu_torch.io.stream import open_stream
from dmlc_tpu_torch.io.threaded_iter import ThreadedIter
from dmlc_tpu_torch.io.uri import URISpec
from dmlc_tpu_torch.utils import knobs as _knobs
from dmlc_tpu_torch.utils import serializer as ser
from dmlc_tpu_torch.utils.check import DMLCError, check
from dmlc_tpu_torch.utils.timer import ThroughputMeter

# 64 MB cache pages (disk_row_iter.h:32 kPageSize)
CACHE_PAGE_BYTES = 64 << 20
_CACHE_MAGIC = b"DMLCTPU-RBCACHE1"

# an autotuned load pass re-tunes the parse tier every this many blocks
AUTOTUNE_LOAD_BLOCKS = 32


class RowBlockIter:
    """Multi-pass iterator interface — analog of dmlc::RowBlockIter
    (data.h:254-274)."""

    def next_block(self) -> Optional[RowBlock]:
        raise NotImplementedError

    def before_first(self) -> None:
        raise NotImplementedError

    @property
    def num_col(self) -> int:
        raise NotImplementedError

    def __iter__(self) -> Iterator[RowBlock]:
        while True:
            blk = self.next_block()
            if blk is None:
                return
            yield blk

    def close(self) -> None:
        pass


class BasicRowIter(RowBlockIter):
    """Drain the parser into memory at construction; each epoch yields one
    block of every row (src/data/basic_row_iter.h:35-42, 61-82).

    With ``autotune`` armed (the argument or ``DMLC_TPU_AUTOTUNE=1``) over
    a parse tier that resizes live, the load pass re-tunes its fan-out
    width every :data:`AUTOTUNE_LOAD_BLOCKS` blocks from the measured
    parallel efficiency (:class:`~dmlc_tpu_torch.data.autotune.ParseTierTuner`);
    the decision record is :attr:`autotune`."""

    def __init__(self, parser: Parser, silent: bool = False,
                 autotune: Optional[bool] = None):
        tuner = None
        if (_knobs.autotune_enabled(autotune)
                and callable(getattr(parser, "resize_parse_workers", None))):
            tuner = ParseTierTuner()
        meter = ThroughputMeter("load", silent=silent)
        container = RowBlockContainer()
        seen = 0
        eff_prev = None
        for block in parser:
            container.push_block(block)
            meter.add(parser.bytes_read - meter.bytes, len(block))
            seen += 1
            if tuner is not None and seen % AUTOTUNE_LOAD_BLOCKS == 0:
                stats_fn = getattr(parser, "parallel_stats", None)
                stats = stats_fn() if callable(stats_fn) else None
                # each decision reads this window's efficiency: the sideband
                # is cumulative and mixes widths after a resize
                eff, eff_prev = efficiency_window(eff_prev, stats)
                parser.resize_parse_workers(
                    tuner.decide(eff, workers=(stats or {}).get("parse_workers")))
        self.block = container.to_block()
        meter.log_final()
        self.load_mb_per_sec = meter.mb_per_sec
        self.autotune = tuner.snapshot() if tuner is not None else None
        self._done = False
        parser.close()

    def next_block(self) -> Optional[RowBlock]:
        if self._done:
            return None
        self._done = True
        return self.block

    def before_first(self) -> None:
        self._done = False

    @property
    def num_col(self) -> int:
        return self.block.num_col


class DiskRowIter(RowBlockIter):
    """Build a page cache of serialized blocks once, then stream its pages
    with a prefetch thread each epoch (src/data/disk_row_iter.h:95-141).
    A cache that opens is served without the parser; a truncated or
    damaged one raises :class:`DMLCError`."""

    def __init__(self, parser: Optional[Parser], cache_file: str,
                 page_bytes: int = CACHE_PAGE_BYTES, silent: bool = False):
        self.cache_file = cache_file
        self.page_bytes = page_bytes
        self._num_col = 0
        self._iter: Optional[ThreadedIter] = None
        if not self._try_load_cache():
            check(parser is not None, f"no cache at {cache_file} and no parser given")
            self._build_cache(parser, silent)
            parser.close()
            check(self._try_load_cache(), "cache build failed to produce a readable cache")

    # the file: [magic][num_col u64][page table offset u64][pages...][npages u64][offsets...]

    def _build_cache(self, parser: Parser, silent: bool) -> None:
        meter = ThroughputMeter("cache-build", log_every_mb=64.0, silent=silent)
        pages: List[int] = []
        container = RowBlockContainer()
        cur_bytes = 0
        with open_stream(self.cache_file, "w") as f:
            f.write(_CACHE_MAGIC)
            ser.write_scalar(f, 0, "uint64")  # num_col, patched below
            ser.write_scalar(f, 0, "uint64")  # the page table's offset, patched below

            def flush_page():
                nonlocal container, cur_bytes
                if len(container) == 0:
                    return
                pages.append(f.tell())
                container.save(f)
                container = RowBlockContainer()
                cur_bytes = 0

            for block in parser:
                container.push_block(block)
                self._num_col = max(self._num_col, block.num_col)
                cur_bytes += block.mem_cost_bytes()
                meter.add(block.mem_cost_bytes(), len(block))
                if cur_bytes >= self.page_bytes:
                    flush_page()
            flush_page()
            tail = f.tell()
            ser.write_scalar(f, len(pages), "uint64")
            for off in pages:
                ser.write_scalar(f, off, "uint64")
        # the header, little-endian like the rest (the reference's wire format)
        with open(self.cache_file, "r+b") as f:
            f.seek(len(_CACHE_MAGIC))
            f.write(struct.pack("<QQ", self._num_col, tail))
        meter.log_final()

    def _try_load_cache(self) -> bool:
        f = open_stream(self.cache_file, "r", allow_null=True)
        if f is None:
            return False
        with f:
            if f.read(len(_CACHE_MAGIC)) != _CACHE_MAGIC:
                return False
            self._num_col = ser.read_scalar(f, "uint64")
            tail = ser.read_scalar(f, "uint64")
            if tail == 0:
                return False
            f.seek(tail)
            npages = ser.read_scalar(f, "uint64")
            self._page_offsets = [ser.read_scalar(f, "uint64") for _ in range(npages)]
        self._start_iter()
        return True

    def _read_pages(self):
        for off in self._page_offsets:
            with open_stream(self.cache_file, "r") as f:
                f.seek(off)
                yield RowBlock.load(f)

    def _start_iter(self) -> None:
        if self._iter is not None:
            self._iter.destroy()
        self._iter = ThreadedIter.from_factory(self._read_pages, max_capacity=2)

    def next_block(self) -> Optional[RowBlock]:
        return self._iter.next()

    def before_first(self) -> None:
        self._iter.before_first()

    @property
    def num_col(self) -> int:
        return int(self._num_col)

    def close(self) -> None:
        if self._iter is not None:
            self._iter.destroy()
            self._iter = None


def create_row_block_iter(
    uri: str,
    part_index: int = 0,
    num_parts: int = 1,
    type_: str = "auto",
    index_dtype=np.uint64,
    silent: bool = False,
    parse_workers: Optional[int] = None,
    block_cache: Optional[str] = None,
    snapshot: Optional[str] = None,
    service: Optional[str] = None,
    service_job: Optional[str] = None,
    shuffle_seed: Optional[int] = None,
    shuffle_window: int = 0,
    pod_sharding=False,
    autotune: Optional[bool] = None,
    **parser_kw,
) -> RowBlockIter:
    """RowBlockIter factory — analog of RowBlockIter::Create (data.h:267,
    src/data.cc:88-107), with the JAX package's signature.

    A ``#cachefile`` URI suffix selects :class:`DiskRowIter` over the page
    cache at that path (``.split<N>.part<K>`` for one of several parts,
    uri_spec.h:47-53), built by the first call and served by later ones;
    without it, :class:`BasicRowIter` drains the parser into memory. The
    parser is :func:`~dmlc_tpu_torch.data.parsers.create_parser`'s, with
    ``parse_workers``, ``block_cache`` (or a ``#blockcache=`` suffix),
    ``snapshot``, ``shuffle_seed`` / ``shuffle_window`` / ``pod_sharding``
    and ``parser_kw`` passed on; the plan knobs cannot combine with the
    page cache, which replays its build order. ``autotune`` re-tunes the
    load pass's parse fan-out (:class:`BasicRowIter`).

    ``service`` (or a ``#service=<host:port>`` URI suffix) streams the
    blocks from a parse-worker fleet instead of parsing locally: the
    drained parser is the :class:`~dmlc_tpu_torch.service.client.
    ServiceParser`, and the dispatcher owns the dataset spec.
    """
    spec = URISpec(uri, part_index, num_parts)
    if service is None:
        service = spec.service
    if service is not None:
        # the plan knobs go along so that the service branch refuses them
        # (the dispatcher owns the plan) instead of serving unshuffled
        # epochs the caller asked to shuffle
        parser = create_parser(uri, part_index, num_parts, type_,
                               index_dtype=index_dtype, service=service,
                               service_job=service_job,
                               shuffle_seed=shuffle_seed,
                               shuffle_window=shuffle_window,
                               pod_sharding=pod_sharding)
        return BasicRowIter(parser, silent=silent, autotune=autotune)
    # the cache here is the page cache (DiskRowIter): strip it off the
    # parser's URI, so the split layer does not chunk-cache to the same
    # path; a #blockcache= suffix belongs to create_parser, which strips it
    parser_uri = uri if spec.block_cache is not None else uri.split("#", 1)[0]

    def parser() -> Parser:
        return create_parser(parser_uri, part_index, num_parts, type_,
                             index_dtype=index_dtype, parse_workers=parse_workers,
                             block_cache=block_cache, snapshot=snapshot,
                             shuffle_seed=shuffle_seed, shuffle_window=shuffle_window,
                             pod_sharding=pod_sharding, **parser_kw)

    if spec.cache_file is None:
        return BasicRowIter(parser(), silent=silent, autotune=autotune)
    # the page cache replays its frozen build order every epoch: it cannot
    # serve an epoch plan, and dropping the knobs would serve a user
    # unshuffled epochs they asked to shuffle
    check(shuffle_seed is None and shuffle_window == 0 and not pod_sharding,
          "shuffle_seed/shuffle_window/pod_sharding cannot combine with "
          "the #cachefile page cache (DiskRowIter replays its frozen "
          "build order); use block_cache= for shuffle-native warm epochs "
          "(docs/data.md)")
    if os.path.exists(spec.cache_file):
        return DiskRowIter(None, spec.cache_file, silent=silent)
    return DiskRowIter(parser(), spec.cache_file, silent=silent)
