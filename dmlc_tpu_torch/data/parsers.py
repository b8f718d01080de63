"""libsvm text parser — analog of src/data/{text_parser.h,libsvm_parser.h}.

Own copy of the libsvm part of the JAX package's ``data/parsers.py``: each
chunk of a :class:`~dmlc_tpu_torch.io.LineSplitter` partition goes through
the C++ native scanner (:mod:`dmlc_tpu_torch.native`) when it built, else
through the vectorized numpy engine; both emit identical RowBlocks.

Semantics matched to the reference: ``label[:weight] [qid:N] idx[:val]...``;
``#`` comments (libsvm_parser.h:67-84); missing values mean binary
features; ``indexing_mode`` 1 means 1-based indices, 0 0-based, -1 the
sklearn-style auto-detect per chunk (libsvm_parser.h:159-168).

Checkpoints follow the JAX package's ``TextParserBase`` and
``ThreadedParser``, key for key. Each non-empty block carries
``resume_state = {"kind": "split", "split": <the split's position just
after the block>, "chunks": n}``; :meth:`ThreadedParser.state_dict` is the
last delivered block's annotation plus ``blocks``, or ``{"kind": "blocks",
"blocks": n}`` before the first block of an epoch. ``load_state`` seeks the
split for a ``split`` state and replays the count for the other kinds, so
a state taken in either package restores in the other.

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
from typing import Callable, Dict, Iterator, Optional, Union

import numpy as np

from dmlc_tpu_torch import native
from dmlc_tpu_torch.data import epoch as _epoch
from dmlc_tpu_torch.data.row_block import RowBlock
from dmlc_tpu_torch.io import block_cache as _bc
from dmlc_tpu_torch.io import resilience as _resilience
from dmlc_tpu_torch.io.input_split import DEFAULT_CHUNK_BYTES, LineSplitter
from dmlc_tpu_torch.io.threaded_iter import OrderedWorkerPool, ThreadedIter
from dmlc_tpu_torch.io.uri import URISpec
from dmlc_tpu_torch.parallel.distributed import pod_identity
from dmlc_tpu_torch.utils import knobs as _knobs
from dmlc_tpu_torch.utils.check import CacheCorruptionError, DMLCError, check
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


# bytes.split() whitespace, as a byte-indexed lookup table
_WS_LUT = np.zeros(256, bool)
_WS_LUT[[9, 10, 11, 12, 13, 32]] = True

# fast-path rejections (with no success yet) before a parser stops trying
# the fast path for good — the corpus structure never qualifies
_FAST_PATH_GIVEUP = 4


def _token_table(chunk: bytes):
    """Vectorized structure scan for simple ``label idx:val ...`` chunks.

    Splits the whole chunk ONCE on whitespace+colon into one token array
    reused for label / index / value extraction, with the per-line
    structure derived from numpy mask scans instead of a per-line loop.
    Returns ``(tokens, nnz, first_idx)``, or None when the chunk needs the
    general path (comments, qid, label:weight, binary/mixed features).
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
        # 'idx:val' signature while the general path reads them otherwise
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
    # every live line must be exactly label + nnz uniform idx:val features
    nnz, rem = np.divmod(lc - 1, 2)
    if rem.any() or not np.array_equal(cc, nnz):
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


class LibSVMParser(Parser):
    """libsvm text -> RowBlock over one LineSplitter partition
    (TextParserBase + libsvm_parser.h:85-169).

    ``engine`` is ``"auto"`` (native scanner when it built, else numpy) or
    ``"python"`` (the numpy engine all the way down).
    """

    def __init__(self, source: LineSplitter, args: Dict[str, str] | None = None,
                 engine: str = "auto"):
        check(engine in ("auto", "python"), f"unknown parse engine {engine!r}")
        self.source = source
        args = dict(args or {})
        check(args.get("format", "libsvm") == "libsvm",
              "LibSVMParser: format must be libsvm")
        try:
            self.indexing_mode = int(args.get("indexing_mode", 0))
        except ValueError as exc:
            raise DMLCError(f"indexing_mode: {exc}") from exc
        check(self.indexing_mode in (-1, 0, 1), "indexing_mode must be -1, 0 or 1")
        self._native = engine == "auto" and native.available()
        self._fast_rejects = 0
        self._fast_saw_hit = False
        self._chunks_in = 0  # chunks pulled this epoch
        self._bytes = 0      # chunk bytes pulled, over the parser's life

    @property
    def engine(self) -> str:
        """The engine in use: ``native`` or ``numpy``."""
        return "native" if self._native else "numpy"

    def next_block(self) -> Optional[RowBlock]:
        while True:
            chunk = self.source.next_chunk()
            if chunk is None:
                return None
            self._bytes += len(chunk)
            self._chunks_in += 1
            block = self.parse_chunk(chunk)
            if len(block) > 0:
                # the position just AFTER this block: prefetching layers
                # downstream checkpoint byte-exactly through it
                block.resume_state = {"kind": "split",
                                      "split": self.source.chunk_resume_state,
                                      "chunks": self._chunks_in}
                return block

    def before_first(self) -> None:
        self.source.before_first()
        self._chunks_in = 0

    def state_dict(self) -> dict:
        """The split's position after the last chunk pulled (the split
        is undecorated, so its live state is exact)."""
        return {"kind": "split", "split": self.source.chunk_resume_state,
                "chunks": self._chunks_in}

    def load_state(self, state: dict) -> None:
        """Seek for a ``split`` state; replay the chunk count, without
        parsing, for a ``chunks`` state."""
        if state.get("kind") == "split":
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

    def parse_chunk(self, chunk: bytes) -> RowBlock:
        if self._native:
            d = native.parse_libsvm(chunk, indexing_mode=self.indexing_mode)
            return RowBlock(offset=d["offset"], label=d["label"], index=d["index"],
                            value=d["value"], weight=d["weight"], qid=d["qid"],
                            hold=d["_owner"])
        try:
            # overflow-range decimals (1e200) cast to float32 as inf — the
            # same saturation the native scanner applies
            with np.errstate(over="ignore"):
                return self.parse_chunk_py(chunk)
        except (ValueError, TypeError) as exc:
            raise DMLCError(f"LibSVMParser: malformed input: {exc}") from exc

    def parse_chunk_py(self, chunk: bytes) -> RowBlock:
        fast = (_token_table(chunk)
                if self._fast_saw_hit or self._fast_rejects < _FAST_PATH_GIVEUP
                else None)
        if fast is not None:
            self._fast_saw_hit = True
            tokens, nnz, first_idx = fast
            label_mask = np.zeros(len(tokens), bool)
            label_mask[first_idx] = True
            labels = tokens[first_idx].astype(np.float32)
            feats = tokens[~label_mask]
            offset = np.concatenate([[0], np.cumsum(nnz)])
            if len(feats) == 0:
                return RowBlock(offset=offset, label=labels,
                                index=np.empty(0, np.uint64))
            index = _apply_indexing_mode(feats[0::2].astype(np.int64),
                                         self.indexing_mode)
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
            return RowBlock(np.zeros(1, np.int64), np.empty(0, np.float32),
                            np.empty(0, np.uint64))
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
        index = _apply_indexing_mode(index, self.indexing_mode)
        return RowBlock(
            offset=np.concatenate([[0], np.cumsum(nnz)]),
            label=labels,
            index=index.astype(np.uint64, copy=False),
            value=value,
            weight=weights,
            qid=np.array(qid_vals, np.int64) if has_qid else None,
        )


class ThreadedParser(Parser):
    """Parse-ahead decorator — analog of ThreadedParser (parser.h:70-126,
    ThreadedIter capacity 8). The producer thread starts on the first pull.

    Its position runs ahead of delivery, so a checkpoint is the annotation
    of the last block delivered. ``load_state`` stops the producer first;
    the next pull starts a new one where the base now stands, without the
    epoch reset a ``before_first`` would run."""

    def __init__(self, base: LibSVMParser):
        self.base = base
        self._iter: Optional[ThreadedIter] = None
        self._delivered = 0
        self._last_annot: Optional[dict] = None

    @property
    def engine(self) -> str:
        return self.base.engine

    def _ensure_iter(self) -> ThreadedIter:
        if self._iter is None:
            self._iter = ThreadedIter(self._produce, self.base.before_first,
                                      max_capacity=8)
        return self._iter

    def _quiesce(self) -> None:
        if self._iter is not None:
            self._iter.destroy()
            self._iter = None

    def _produce(self):
        block = self.base.next_block()
        return block is not None, block

    def next_block(self) -> Optional[RowBlock]:
        block = self._ensure_iter().next()
        if block is not None:
            self._delivered += 1
            self._last_annot = block.resume_state
        return block

    def before_first(self) -> None:
        self._ensure_iter().before_first()
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
        self._delivered = n
        self._last_annot = None

    @property
    def bytes_read(self) -> int:
        return self.base.bytes_read

    def close(self) -> None:
        self._quiesce()
        self.base.close()


def annot_key(state: Optional[dict]) -> str:
    """The comparison key of a resume annotation: without the wrapper's
    ``blocks`` counter, through JSON, keys sorted (the JAX package's
    ``annot_key``)."""
    norm = {k: v for k, v in (state or {}).items() if k != "blocks"}
    return json.dumps(json.loads(json.dumps(norm, default=str)), sort_keys=True)


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

    The JAX package's autotuning passthroughs (``resize_parse_workers``,
    ``resize_plan_read_workers``, ``parallel_stats``) and its profiler
    annotations are not ported.
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
        writer.add_block(block.to_segments(), rows=len(block), num_col=block.num_col,
                         resume=annot)

    def _add_cache_read(self, dt: float) -> None:
        with self._cr_lock:
            self._cache_read_seconds += dt

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
                segments = reader.load_segments(i)
            except CacheCorruptionError:
                self._add_cache_read(get_time() - t0)
                self._heal_corruption()
                return self._next_cold()
            block = RowBlock.from_segments(segments, hold=reader.hold)
            annot = reader.resume(i)
            if annot is not None:
                block.resume_state = annot
            self._bytes += reader.block_nbytes(i)
            self._add_cache_read(get_time() - t0)
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
            rowperm = plan.row_order(bidx, reader.block_rows(bidx))
            copy = rowperm is None and plan.permuted
            segments = reader.load_segments(bidx, copy=copy)
            # a row gather may pass the permutation-invariant index array
            # through as a view: the mmap stays held then
            block = RowBlock.from_segments(segments, hold=None if copy else reader.hold)
            if rowperm is not None:
                uniform = self._uniform_cols.get(bidx)
                if uniform is None:
                    uniform = _epoch.uniform_column_pattern(block)
                    self._uniform_cols[bidx] = uniform
                block = _epoch.permute_block_rows(block, rowperm, uniform_columns=uniform)
        finally:
            self._add_cache_read(get_time() - t0)
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
        self._drop_reader()
        _bc.remove_quietly(self.cache_file)
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
        self._drop_reader()
        _bc.remove_quietly(self.cache_file)
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
                    writer.finish()  # fsync + publish
                return None
            annot = block.resume_state
            writer = self._ensure_writer()
            if writer is not None:
                self._tee_block(writer, block, annot)
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
        """``{"cache_read": seconds}``: warm block reads (the port has no
        parse stage clock)."""
        return {"cache_read": self._cache_read_seconds}

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


def create_parser(uri: str, part_index: int = 0, num_parts: int = 1,
                  type_: str = "auto", index_dtype=np.uint64, threaded: bool = True,
                  *, engine: str = "auto", snapshot: Optional[str] = None,
                  chunk_bytes: int = DEFAULT_CHUNK_BYTES, block_cache: Optional[str] = None,
                  shuffle_seed: Optional[int] = None, shuffle_window: int = 0,
                  pod_sharding=False) -> Parser:
    """Parser factory — analog of dmlc::Parser::Create (src/data.cc:62-85).

    The positional parameters are the JAX package's: ``type_='auto'``
    resolves from the URI's ``format=`` argument and defaults to libsvm,
    the one format this port parses so far; ``index_dtype`` must be
    ``np.uint64`` (the blocks' index type; another raises); ``threaded``
    parses ahead on a thread of its own (:class:`ThreadedParser`), and
    ``threaded=False`` returns the bare :class:`LibSVMParser`. URI
    arguments (``?indexing_mode=1``) flow into the parser. The port's own
    options are keyword-only: ``engine`` as in :class:`LibSVMParser`;
    ``chunk_bytes`` is the split's chunk size (at least 4096), which sets
    the blocks and enters the cache and snapshot signature.

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

    ``snapshot`` arms the snapshot store: the parser carries
    ``snapshot_path`` (suffixed ``.split<N>.part<K>`` for one of several
    parts) and ``snapshot_signature``, the source key a snapshot is bound
    to, which a :class:`~dmlc_tpu_torch.data.device.DeviceIter` over it
    picks up. It does not combine with ``shuffle_seed``: shuffled snapshot
    epochs come from ``DeviceIter``'s ``snapshot_shuffle_seed``.

    The signatures equal the JAX package's for the same corpus and
    settings, so a cache or a snapshot written by either package opens in
    the other. The JAX package's mapping of the split layer's legacy
    ``shuffle`` / ``num_shuffle_parts`` arguments onto the plan has nothing
    to map from here, as the port's split takes no such arguments.
    """
    spec = URISpec(uri)
    if type_ == "auto":
        type_ = spec.args.get("format", "libsvm")
    if type_ != "libsvm":
        raise DMLCError(f"unknown parser format {type_!r}; dmlc_tpu_torch "
                        "parses 'libsvm'")
    if np.dtype(index_dtype) != np.dtype(np.uint64):
        raise DMLCError(f"index_dtype {np.dtype(index_dtype)}: dmlc_tpu_torch "
                        "parses uint64 indices only")
    bc_path = _resolve_block_cache(spec, part_index, num_parts, block_cache)
    if snapshot is not None and num_parts != 1:
        snapshot = f"{snapshot}.split{num_parts}.part{part_index}"
    check(snapshot is None or shuffle_seed is None,
          "snapshot= cannot combine with shuffle_seed= (the snapshot "
          "freezes one epoch's batch order) — use DeviceIter's "
          "snapshot_shuffle_seed for shuffled snapshot epochs "
          "(docs/data.md)")
    # the engine is left out of the signature: every engine emits the
    # same blocks from the same chunks
    signature = _bc.source_signature(
        spec.uri, part_index, num_parts, format=type_,
        args={k: v for k, v in spec.args.items() if k != "engine"},
        index_dtype=np.dtype(np.uint64).str, chunk_bytes=int(chunk_bytes), split={})

    def build() -> Parser:
        split = LineSplitter(spec.uri, part_index, num_parts, chunk_bytes=chunk_bytes)
        parser = LibSVMParser(split, spec.args, engine=engine)
        return ThreadedParser(parser) if threaded else parser

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
    if snapshot is not None:
        parser.snapshot_path = snapshot
        parser.snapshot_signature = signature
    return parser
