"""Sparse row blocks: the numpy CSR batch unit the parsers emit.

Own copy of the JAX package's ``data/row_block.py`` (RowBlock,
RowBlockContainer), trimmed to the fields the libsvm path carries —
reference include/dmlc/data.h (RowBlock data.h:175-236) and
src/data/row_block.h (RowBlockContainer).

Layout (CSR):
    offset  int64[n+1]   row i spans index/value[offset[i]:offset[i+1]]
    label   float32[n]
    weight  float32[n]   optional (None = unweighted)
    qid     int64[n]     optional query ids
    index   uint64[nnz]  feature ids
    value   float32[nnz] optional (None = binary features)
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from dmlc_tpu_torch.utils.check import check


class RowBlock:
    """CSR batch — analog of dmlc::RowBlock (data.h:175-236)."""

    def __init__(
        self,
        offset: np.ndarray,
        label: np.ndarray,
        index: np.ndarray,
        value: Optional[np.ndarray] = None,
        weight: Optional[np.ndarray] = None,
        qid: Optional[np.ndarray] = None,
        hold=None,
    ):
        # `hold` pins foreign buffer owners (the native core's malloc'd
        # results) for as long as this block's views are alive
        self.hold = hold
        # the source's position just after this block, set by the parser
        # that emitted it (a checkpoint annotation); slices do not carry it
        self.resume_state: Optional[dict] = None
        self.offset = np.asarray(offset, dtype=np.int64)
        self.label = np.asarray(label, dtype=np.float32)
        self.index = np.asarray(index)
        self.value = None if value is None else np.asarray(value, dtype=np.float32)
        self.weight = None if weight is None else np.asarray(weight, dtype=np.float32)
        self.qid = None if qid is None else np.asarray(qid, dtype=np.int64)
        n = len(self.label)
        check(len(self.offset) == n + 1, "RowBlock: offset must have size n+1")
        nnz = int(self.offset[-1])
        check(len(self.index) == nnz, "RowBlock: index size mismatch with offset[-1]")
        check(self.value is None or len(self.value) == nnz,
              "RowBlock: value size mismatch")
        for name in ("weight", "qid"):
            arr = getattr(self, name)
            check(arr is None or len(arr) == n, f"RowBlock: {name} size mismatch")

    def __len__(self) -> int:
        return len(self.label)

    @property
    def num_col(self) -> int:
        """max feature id + 1 (0 for a block without features)."""
        return int(self.index.max()) + 1 if len(self.index) else 0

    # -- columnar segment round trip (io/block_cache.py format) --

    def to_segments(self) -> dict:
        """The block's arrays as the named columnar segments the block
        cache serializes (:data:`dmlc_tpu_torch.io.block_cache.SEGMENT_NAMES`);
        absent optional arrays map to None. The port's blocks carry no
        ``field`` (libfm is not ported)."""
        return {"offset": self.offset, "label": self.label, "weight": self.weight,
                "qid": self.qid, "field": None, "index": self.index,
                "value": self.value}

    @staticmethod
    def from_segments(segments: dict, hold=None) -> "RowBlock":
        """Rebuild a block from :meth:`to_segments` output. The segment
        dtypes are the block's, so mmap-backed views pass through
        zero-copy; ``hold`` keeps their buffer owner (the reader's mmap)
        alive for as long as the block's views are."""
        check(segments.get("field") is None,
              "RowBlock.from_segments: a 'field' segment (libfm blocks) is not "
              "supported by dmlc_tpu_torch")
        return RowBlock(offset=segments["offset"], label=segments["label"],
                        index=segments["index"], value=segments.get("value"),
                        weight=segments.get("weight"), qid=segments.get("qid"),
                        hold=hold)

    def slice(self, begin: int, end: int) -> "RowBlock":
        """Sub-block of rows [begin, end) (RowBlock::Slice, data.h:216)."""
        check(0 <= begin <= end <= len(self), "RowBlock.slice: bad range")
        s, e = int(self.offset[begin]), int(self.offset[end])
        return RowBlock(
            offset=self.offset[begin:end + 1] - s,
            label=self.label[begin:end],
            index=self.index[s:e],
            value=self.value[s:e] if self.value is not None else None,
            weight=self.weight[begin:end] if self.weight is not None else None,
            qid=self.qid[begin:end] if self.qid is not None else None,
            hold=self.hold,
        )


class RowBlockContainer:
    """Growable RowBlock accumulator; ``to_block`` concatenates once."""

    def __init__(self):
        self._offsets: List[np.ndarray] = []
        self._labels: List[np.ndarray] = []
        self._indices: List[np.ndarray] = []
        self._values: List[Optional[np.ndarray]] = []
        self._weights: List[Optional[np.ndarray]] = []
        self._qids: List[Optional[np.ndarray]] = []

    def push_block(self, block: RowBlock) -> None:
        if len(block) == 0:
            return
        self._offsets.append(np.diff(block.offset))
        self._labels.append(block.label)
        self._indices.append(block.index)
        self._values.append(block.value)
        self._weights.append(block.weight)
        self._qids.append(block.qid)

    @staticmethod
    def _cat_optional(parts: List[Optional[np.ndarray]], sizes: List[int], dtype):
        """Concatenate optional per-block arrays; missing blocks get
        defaults (ones for float columns, zeros otherwise)."""
        if all(p is None for p in parts):
            return None
        filled = []
        for p, n in zip(parts, sizes):
            if p is None:
                filled.append(np.ones(n, dtype) if dtype == np.float32 else np.zeros(n, dtype))
            else:
                filled.append(p)
        return np.concatenate(filled)

    def to_block(self) -> RowBlock:
        if not self._labels:
            return RowBlock(np.zeros(1, np.int64), np.empty(0, np.float32),
                            np.empty(0, np.uint64))
        row_counts = [len(lab) for lab in self._labels]
        nnz_counts = [len(i) for i in self._indices]
        offset = np.concatenate([[0], np.cumsum(np.concatenate(self._offsets))])
        label = np.concatenate(self._labels)
        index = np.concatenate(self._indices).astype(np.uint64, copy=False)
        value = self._cat_optional(self._values, nnz_counts, np.float32)
        weight = self._cat_optional(self._weights, row_counts, np.float32)
        qid = self._cat_optional(self._qids, row_counts, np.int64)
        return RowBlock(offset, label, index, value, weight, qid)
