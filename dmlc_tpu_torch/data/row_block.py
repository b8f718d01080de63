"""Row blocks: the numpy batch units the parsers emit.

Own copy of the JAX package's ``data/row_block.py`` (Row, RowBlock,
RowBlockContainer, DenseBlock, CooBlock) — reference include/dmlc/data.h
(Row data.h:74-162, RowBlock data.h:175-236) and src/data/row_block.h
(RowBlockContainer). ``RowBlock.save`` / ``load`` write and read the JAX
package's bytes (:mod:`dmlc_tpu_torch.utils.serializer`). It carries
every field the libsvm, csv and libfm parsers fill.

Layout (CSR):
    offset  int64[n+1]   row i spans index/value[offset[i]:offset[i+1]]
    label   float32[n]
    weight  float32[n]   optional (None = unweighted)
    qid     int64[n]     optional query ids
    field   uint64[nnz]  optional libfm field ids (data.h:102)
    index   uint64[nnz]  feature ids
    value   float32[nnz] optional (None = binary features)

:class:`DenseBlock` is a parsed batch already in the dense layout ``[n,
num_col]``, which a parser emits after ``set_emit_dense``: unpacked
(``x``, ``label`` and ``weight`` apart), or packed by the fused native
reader (``x`` one ``[n, num_col + 2]`` slab, ``label`` and ``weight`` views
of its trailing columns; a bfloat16 slab is a ``uint16`` view of its bits).
:class:`CooBlock` is a batch in the native COO emit's layout
(``set_emit_coo`` on the fused reader).
"""

from __future__ import annotations

from typing import BinaryIO, Iterator, List, Optional

import numpy as np

from dmlc_tpu_torch.utils import serializer as ser
from dmlc_tpu_torch.utils.check import check


class Row:
    """One sparse row view — analog of dmlc::Row (data.h:74-162)."""

    __slots__ = ("label", "weight", "qid", "field", "index", "value")

    def __init__(self, label, weight, qid, field, index, value):
        self.label = label
        self.weight = weight
        self.qid = qid
        self.field = field
        self.index = index
        self.value = value

    def __len__(self) -> int:
        return len(self.index)

    def get_value(self, i: int) -> float:
        """The i-th entry's value; a binary feature reads 1 (data.h:132)."""
        return 1.0 if self.value is None else float(self.value[i])

    def sdot(self, weight_vec: np.ndarray) -> float:
        """Sparse dot with a dense weight vector (Row::SDot, data.h:146-161)."""
        w = weight_vec[self.index]
        if self.value is None:
            return float(np.sum(w))
        return float(np.dot(w, self.value))


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
        field: Optional[np.ndarray] = None,
        hold=None,
    ):
        # `hold` pins foreign buffer owners (the native core's malloc'd
        # results) for as long as this block's views are alive
        self.hold = hold
        # the source's position just after this block, set by the parser
        # that emitted it (a checkpoint annotation); slices do not carry it
        self.resume_state: Optional[dict] = None
        # the (trace_id, span_id) of the data-service grant that produced
        # it (a service client sets it); DeviceIter's dispatch span joins it
        self.trace_ctx: Optional[tuple] = None
        self.offset = np.asarray(offset, dtype=np.int64)
        self.label = np.asarray(label, dtype=np.float32)
        self.index = np.asarray(index)
        self.value = None if value is None else np.asarray(value, dtype=np.float32)
        self.weight = None if weight is None else np.asarray(weight, dtype=np.float32)
        self.qid = None if qid is None else np.asarray(qid, dtype=np.int64)
        self.field = None if field is None else np.asarray(field)
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
    def num_nonzero(self) -> int:
        return int(self.offset[-1])

    @property
    def num_col(self) -> int:
        """max feature id + 1 (0 for a block without features)."""
        return int(self.index.max()) + 1 if len(self.index) else 0

    def __getitem__(self, i):
        """Row ``i`` as a :class:`Row` view (RowBlock::operator[],
        data.h:365-394); a slice gives the :meth:`slice` sub-block."""
        if isinstance(i, slice):
            check(i.step in (None, 1), "RowBlock: stepped slices unsupported")
            begin, end, _ = i.indices(len(self))
            return self.slice(begin, max(begin, end))
        if i < 0:
            i += len(self)
        check(0 <= i < len(self), f"RowBlock: row {i} out of range")
        s, e = int(self.offset[i]), int(self.offset[i + 1])
        return Row(float(self.label[i]),
                   float(self.weight[i]) if self.weight is not None else 1.0,
                   int(self.qid[i]) if self.qid is not None else None,
                   self.field[s:e] if self.field is not None else None,
                   self.index[s:e],
                   self.value[s:e] if self.value is not None else None)

    def __iter__(self) -> Iterator[Row]:
        for i in range(len(self)):
            yield self[i]

    def mem_cost_bytes(self) -> int:
        """Approximate memory cost (RowBlock::MemCostBytes, data.h:203)."""
        cost = self.offset.nbytes + self.label.nbytes + self.index.nbytes
        for arr in (self.value, self.weight, self.qid, self.field):
            if arr is not None:
                cost += arr.nbytes
        return cost

    # -- binary round trip (row_block.h:189-215), the JAX package's bytes --

    def save(self, stream: BinaryIO) -> None:
        ser.write_obj(stream, {"offset": self.offset, "label": self.label, "index": self.index,
                               "value": self.value, "weight": self.weight, "qid": self.qid,
                               "field": self.field})

    @staticmethod
    def load(stream: BinaryIO) -> "RowBlock":
        d = ser.read_obj(stream)
        return RowBlock(offset=d["offset"], label=d["label"], index=d["index"],
                        value=d["value"], weight=d["weight"], qid=d["qid"], field=d["field"])

    # -- columnar segment round trip (io/block_cache.py format) --

    def to_segments(self) -> dict:
        """The block's arrays as the named columnar segments the block
        cache serializes (:data:`dmlc_tpu_torch.io.block_cache.SEGMENT_NAMES`);
        absent optional arrays map to None."""
        return {"offset": self.offset, "label": self.label, "weight": self.weight,
                "qid": self.qid, "field": self.field, "index": self.index,
                "value": self.value}

    @staticmethod
    def from_segments(segments: dict, hold=None) -> "RowBlock":
        """Rebuild a block from :meth:`to_segments` output. The segment
        dtypes are the block's, so mmap-backed views pass through
        zero-copy; ``hold`` keeps their buffer owner (the reader's mmap)
        alive for as long as the block's views are."""
        return RowBlock(offset=segments["offset"], label=segments["label"],
                        index=segments["index"], value=segments.get("value"),
                        weight=segments.get("weight"), qid=segments.get("qid"),
                        field=segments.get("field"), hold=hold)

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
            field=self.field[s:e] if self.field is not None else None,
            hold=self.hold,
        )


class DenseBlock:
    """A parsed batch already in the dense layout ``[n, num_col]``, emitted
    by a parser in dense mode (``set_emit_dense``): it skips the CSR block
    entirely. The reference has no analog (its parsers always build CSR,
    src/data/row_block.h). ``packed``: ``x`` is ``[n, num_col + 2]`` with
    label and weight as its trailing columns, and ``label``/``weight`` are
    views of them in ``x``'s dtype (``uint16`` bits for a bfloat16 slab).
    ``device_span`` (a data-service snapshot frame's block) is
    ``(u8 payload, span layout, stored kind)``: the frame's verbatim bytes,
    which a ``device_decode=True`` :class:`~dmlc_tpu_torch.data.device.
    DeviceIter` ships and decodes on the device; ``trace_ctx`` the
    ``(trace_id, span_id)`` of the grant that produced the block."""

    __slots__ = ("x", "label", "weight", "hold", "resume_state", "packed",
                 "device_span", "trace_ctx")

    def __init__(self, x: np.ndarray, label: np.ndarray,
                 weight: Optional[np.ndarray] = None, hold=None, packed: bool = False):
        self.x = x
        self.label = label
        self.weight = weight
        self.hold = hold  # the native result owning the views
        self.packed = packed
        self.resume_state: Optional[dict] = None  # the parser's position after it
        self.device_span = None
        self.trace_ctx: Optional[tuple] = None

    def __len__(self) -> int:
        return len(self.label)

    def slice(self, begin: int, end: int) -> "DenseBlock":
        """Row range view [begin, end), as :meth:`RowBlock.slice`."""
        return DenseBlock(self.x[begin:end], self.label[begin:end],
                          self.weight[begin:end] if self.weight is not None else None,
                          hold=self.hold, packed=self.packed)


class CooBlock:
    """A batch in the native COO emit's layout (the JAX package's class):
    ``coords`` int32 ``[nnz_padded, 2]`` (row, col), or on the CSR wire the
    columns alone ``[nnz_padded]`` with ``row_ptr`` int32 ``[rows_padded +
    1]``; ``values`` float32 ``[nnz_padded]``, None when the block is all
    ones and elision is on; ``label``/``weight`` ``[rows_padded]``.
    ``n_rows`` and ``nnz`` are the real counts. The native emit pads with
    out-of-bounds coordinates (row ``rows_padded``, column ``num_col``) and
    clamps an id past the width to column ``num_col`` inside the real
    entries; :func:`dmlc_tpu_torch.ops.sparse.coo_block_tensors` maps both
    to the port's in-bounds pad scheme."""

    __slots__ = ("coords", "values", "label", "weight", "n_rows", "nnz",
                 "num_col", "hold", "resume_state", "row_ptr", "trace_ctx")

    def __init__(self, coords: np.ndarray, values: Optional[np.ndarray],
                 label: np.ndarray, weight: np.ndarray, n_rows: int, nnz: int,
                 num_col: int, hold=None, row_ptr: Optional[np.ndarray] = None):
        self.row_ptr = row_ptr
        self.coords = coords
        self.values = values
        self.label = label
        self.weight = weight
        self.n_rows = n_rows
        self.nnz = nnz
        self.num_col = num_col
        self.hold = hold
        self.resume_state: Optional[dict] = None
        self.trace_ctx: Optional[tuple] = None

    @property
    def shape(self):
        """The sparse shape: (padded rows, declared width)."""
        return (len(self.label), self.num_col)

    def __len__(self) -> int:
        return self.n_rows


class RowBlockContainer:
    """Growable RowBlock accumulator; ``to_block`` concatenates once."""

    def __init__(self):
        self._offsets: List[np.ndarray] = []
        self._labels: List[np.ndarray] = []
        self._indices: List[np.ndarray] = []
        self._values: List[Optional[np.ndarray]] = []
        self._weights: List[Optional[np.ndarray]] = []
        self._qids: List[Optional[np.ndarray]] = []
        self._fields: List[Optional[np.ndarray]] = []

    def push_block(self, block: RowBlock) -> None:
        if len(block) == 0:
            return
        self._offsets.append(np.diff(block.offset))
        self._labels.append(block.label)
        self._indices.append(block.index)
        self._values.append(block.value)
        self._weights.append(block.weight)
        self._qids.append(block.qid)
        self._fields.append(block.field)

    def push_row(self, label: float, index, value=None, weight=None, qid=None,
                 field=None) -> None:
        index = np.asarray(index, dtype=np.uint64)
        self._offsets.append(np.array([len(index)], dtype=np.int64))
        self._labels.append(np.array([label], dtype=np.float32))
        self._indices.append(index)
        self._values.append(None if value is None else np.asarray(value, np.float32))
        self._weights.append(None if weight is None else np.array([weight], np.float32))
        self._qids.append(None if qid is None else np.array([qid], np.int64))
        self._fields.append(None if field is None else np.asarray(field, np.uint64))

    def __len__(self) -> int:
        return sum(len(lab) for lab in self._labels)

    def clear(self) -> None:
        self.__init__()

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
        field = self._cat_optional(self._fields, nnz_counts, np.uint64)
        return RowBlock(offset, label, index, value, weight, qid, field)
