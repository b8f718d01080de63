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
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np

from dmlc_tpu_torch import native
from dmlc_tpu_torch.data.row_block import RowBlock
from dmlc_tpu_torch.io.block_cache import source_signature
from dmlc_tpu_torch.io.input_split import DEFAULT_CHUNK_BYTES, LineSplitter
from dmlc_tpu_torch.io.threaded_iter import ThreadedIter
from dmlc_tpu_torch.io.uri import URISpec
from dmlc_tpu_torch.utils.check import DMLCError, check


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


def create_parser(uri: str, part_index: int = 0, num_parts: int = 1,
                  type_: str = "auto", engine: str = "auto",
                  snapshot: Optional[str] = None,
                  chunk_bytes: int = DEFAULT_CHUNK_BYTES) -> Parser:
    """Parser factory — analog of dmlc::Parser::Create (src/data.cc:62-85).

    ``type_='auto'`` resolves from the URI's ``format=`` argument and
    defaults to libsvm, the one format this port parses so far. URI
    arguments (``?indexing_mode=1``) flow into the parser, which parses
    ahead on its own thread (:class:`ThreadedParser`). ``engine`` as in
    :class:`LibSVMParser`. ``chunk_bytes`` is the split's chunk size (at
    least 4096), which sets the blocks and enters the snapshot signature.

    ``snapshot`` arms the snapshot store: the parser carries
    ``snapshot_path`` (suffixed ``.split<N>.part<K>`` for one of several
    parts) and ``snapshot_signature``, the source key a snapshot is bound
    to, which a :class:`~dmlc_tpu_torch.data.device.DeviceIter` over it
    picks up. The signature equals the JAX package's for the same corpus
    and settings, so a snapshot written by either package opens in the
    other.
    """
    spec = URISpec(uri)
    if type_ == "auto":
        type_ = spec.args.get("format", "libsvm")
    if type_ != "libsvm":
        raise DMLCError(f"unknown parser format {type_!r}; dmlc_tpu_torch "
                        "parses 'libsvm'")
    split = LineSplitter(spec.uri, part_index, num_parts, chunk_bytes=chunk_bytes)
    parser = ThreadedParser(LibSVMParser(split, spec.args, engine=engine))
    if snapshot is not None:
        if num_parts != 1:
            snapshot = f"{snapshot}.split{num_parts}.part{part_index}"
        # the engine is left out: every engine emits the same blocks
        args = {k: v for k, v in spec.args.items() if k != "engine"}
        parser.snapshot_path = snapshot
        parser.snapshot_signature = source_signature(
            spec.uri, part_index, num_parts, format=type_, args=args,
            index_dtype=np.dtype(np.uint64).str, chunk_bytes=int(chunk_bytes),
            split={})
    return parser
