"""Device-side decode: raw container spans -> typed batches on the card.

The PyTorch counterpart of the JAX package's ``ops/device_decode.py``. A
warm snapshot epoch with ``device_decode=True`` copies each batch's raw
``[pos, end)`` container bytes to the card as one u8 span, and
:func:`decode_batch` turns the span into the batch with one launch of
kernel K2 (``csrc/widen_span.cu``), which replaces the TPU kernel
``widen_span_pallas`` and what the JAX package's ``decode_span`` compiles
around it into one XLA program a layout:

- a :class:`DecodePlan`, built once per ``(kind, layout, num_col)`` and
  cached (:func:`plan_for`), holds the kernel's descriptor table (at most
  ``MAX_BATCH_ARRAYS`` entries, packed once into a ctypes structure), the
  size of the batch's one output allocation, and where each of the batch's
  tensors lies: in that allocation (16-byte aligned) or in the span.
  Segments that need no work (int32 ELL indices, 1-D float32 label, weight
  and scale columns, u8) are views of the span;
- a CUDA span's dispatch (:func:`decode_batch_cuda`) is a plan lookup, one
  ``torch.empty``, the views, and one ctypes call on the current stream.
  The kernel copies 2-D float32/bfloat16 slabs, dequantizes an int8 packed
  dense slab (``dense_packed_q8``), and widens a bfloat16 packed dense
  slab's label and weight columns to float32 in the same pass as its copy
  (:class:`PackedDenseBatch`'s ``aux``);
- a CPU span takes :func:`decode_batch_plain`, the plain version: the
  per-segment composition of :func:`widen_span_plain`, :func:`dequant_q8`
  and :func:`widen_f32`, with the JAX package's arithmetic.

:func:`decode_span` keeps the JAX counterpart's ``{name: tensor}`` contract
on the same plans and kernel; :func:`widen_span` and :func:`widen_span_cuda`
decode one segment through a one-entry plan. Every route gives the bytes of
the host ``np.frombuffer`` views, and of JAX's ``q.astype(f32) * scale`` and
``astype(f32)`` for the dequant and the widening. A CUDA span goes to the
kernel or the call raises (a build or launch failure, a layout no plan
takes); only a CPU span takes the plain version. :func:`quantize_int8` is
the host half of the int8 snapshot path.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from dmlc_tpu_torch.io.block_cache import torch_dtype
from dmlc_tpu_torch.io.snapshot import MAX_BATCH_ARRAYS
from dmlc_tpu_torch.ops import _build
from dmlc_tpu_torch.ops.sparse import EllBatch
from dmlc_tpu_torch.utils.check import DMLCError, check

# a span layout: ((name, dtype_str, rel_offset, nbytes, shape), ...), built
# by io.block_cache.span_layout from a container's footer
Layout = Tuple[Tuple[str, str, int, int, Tuple[int, ...]], ...]

_WIDE = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
_DTYPE_STR = {torch.float32: "<f4", torch.bfloat16: "bfloat16"}

# the kernel's entries (csrc/widen_span.cu)
OP_COPY4, OP_COPY2, OP_DEQUANT_Q8, OP_BF16_AUX = 1, 2, 3, 4
# the kernel's table holds MAX_BATCH_ARRAYS (8) entries: one a segment of a
# snapshot batch at most
_THREADS = 256        # the kernel's block: one 16-byte output vector a thread
_VEC = 16
# the batch kinds a snapshot stores and their array counts; SEGMENTS is
# decode_span's {name: tensor}, which takes any layout
SEGMENTS = "segments"
_KIND_ARRAYS = {"ell": 4, "dense": 3, "dense_packed": 1, "dense_packed_q8": 2}
_MAX_PLANS = 256

# kernel launches since the last reset (chip_smoke.py zeroes it before a
# path and reads it after, to show the path went through the kernel)
launches = 0


class PackedDenseBatch:
    """One ``[B, num_col + 2]`` device tensor: features in columns
    ``[:num_col]``, label in column ``num_col``, weight in ``num_col + 1``.

    ``x, y, w = batch`` works, as does ``batch[i]``, which builds only the
    one tensor asked for, as the JAX class does. ``x`` is a view in the
    packed dtype; ``y`` and ``w`` are float32, so consumers see the dtypes
    of the unpacked path: the rows of ``aux`` (float32 ``[2, B]``, widened
    by the decode kernel) where the batch has one, else the packed columns
    widened on access (:func:`widen_f32`).
    """

    __slots__ = ("packed", "num_col", "aux")

    def __init__(self, packed: torch.Tensor, num_col: int,
                 aux: Optional[torch.Tensor] = None):
        self.packed = packed
        self.num_col = int(num_col)
        self.aux = aux

    @property
    def x(self) -> torch.Tensor:
        return self.packed[:, : self.num_col]

    @property
    def y(self) -> torch.Tensor:
        if self.aux is not None:
            return self.aux[0]
        return widen_f32(self.packed[:, self.num_col])

    @property
    def w(self) -> torch.Tensor:
        if self.aux is not None:
            return self.aux[1]
        return widen_f32(self.packed[:, self.num_col + 1])

    def __iter__(self):
        return iter((self.x, self.y, self.w))

    def __getitem__(self, i):
        if isinstance(i, slice):
            return (self.x, self.y, self.w)[i]
        if i in (0, -3):
            return self.x
        if i in (1, -2):
            return self.y
        if i in (2, -1):
            return self.w
        raise IndexError(i)

    def __len__(self) -> int:
        return 3

    def tree_flatten(self):
        """``((packed, aux), num_col)``: the tensors and the static width,
        the JAX class's pytree split (``dmlc_tpu/data/device.py:337``)."""
        return (self.packed, self.aux), self.num_col

    @classmethod
    def tree_unflatten(cls, num_col, children) -> "PackedDenseBatch":
        return cls(children[0], num_col, *children[1:])


def quantize_int8(arr) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-column int8 quantization of a 2-D float batch:
    ``(q8, scale)`` with float32 ``scale = absmax / 127`` per column (zero
    columns get 1.0, so they dequantize to exact zeros)."""
    a = np.asarray(arr, dtype=np.float32)
    check(a.ndim == 2, "quantize_int8: expected a 2-D [rows, cols] batch")
    scale = np.abs(a).max(axis=0) / 127.0
    scale[scale == 0.0] = 1.0
    q = np.clip(np.rint(a / scale), -127, 127).astype(np.int8)
    return q, scale.astype(np.float32)


def dequant_q8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 ``q [B, C]`` widened to float32 and scaled per column."""
    return q.to(torch.float32) * scale


def widen_f32(col: torch.Tensor) -> torch.Tensor:
    """A (bfloat16) column widened to float32; float32 passes unchanged."""
    return col.to(torch.float32)


def wrap_batch(kind: str, arrays: List[torch.Tensor], num_col: int):
    """The batch object of ``kind`` over its typed arrays, in stored order:
    an ``EllBatch``, a :class:`PackedDenseBatch` (a ``dense_packed_q8``
    batch dequantized by :func:`dequant_q8`), or ``(x, y, w)``."""
    if kind == "ell":
        return EllBatch(*arrays)
    if kind == "dense_packed":
        return PackedDenseBatch(arrays[0], num_col)
    if kind == "dense_packed_q8":
        return PackedDenseBatch(dequant_q8(arrays[0], arrays[1]), num_col)
    check(kind == "dense", f"decode: unknown batch kind {kind!r}")
    return tuple(arrays)


# ---------------- the plan ----------------

class _Op(ctypes.Structure):
    """``DmlcDecodeOp`` in ``csrc/widen_span.cu``."""
    _fields_ = [("op", ctypes.c_int32), ("reserved", ctypes.c_int32),
                ("src", ctypes.c_int64), ("dst", ctypes.c_int64),
                ("rows", ctypes.c_int64), ("cols", ctypes.c_int64),
                ("extra", ctypes.c_int64), ("first_block", ctypes.c_int64)]


class DecodeTable(ctypes.Structure):
    """``DmlcDecodeTable`` in ``csrc/widen_span.cu``: the kernel's
    parameter, passed by value."""
    _fields_ = [("count", ctypes.c_int32), ("reserved", ctypes.c_int32),
                ("blocks", ctypes.c_int64), ("ops", _Op * MAX_BATCH_ARRAYS)]


def _round16(n: int) -> int:
    return -(-n // _VEC) * _VEC


class DecodePlan:
    """How one ``(kind, layout, num_col)`` decodes, fixed once.

    ``outputs`` lists the batch's tensors in stored order, each as
    ``(in_out, offset, nbytes, dtype, itemsize, shape, strides)``: a view
    of the output allocation (``in_out``) or of the span. ``aux`` is the
    float32 ``[2, B]`` label and weight of a bfloat16 packed dense batch,
    as ``(offset, nbytes, dtype, itemsize, shape)`` in the output
    allocation, or None. ``table`` is the kernel's descriptor table,
    ``out_bytes`` the output allocation's size, ``span_bytes`` the least
    span the layout reads. ``direct`` is ``(dtype, shape)`` where the
    allocation holds one tensor, which is then allocated typed and needs no
    carving, else None.
    """

    __slots__ = ("kind", "num_col", "names", "outputs", "aux", "out_bytes",
                 "span_bytes", "direct", "table", "table_ptr")

    def __init__(self, kind: str, layout: Layout, num_col: int):
        check(kind == SEGMENTS or kind in _KIND_ARRAYS, f"decode: unknown batch kind {kind!r}")
        check(len(layout) <= MAX_BATCH_ARRAYS,
              f"decode: a span of {len(layout)} segments (at most {MAX_BATCH_ARRAYS})")
        check(kind == SEGMENTS or len(layout) == _KIND_ARRAYS[kind],
              f"decode: a {kind} batch holds {_KIND_ARRAYS.get(kind)} arrays, "
              f"the layout {len(layout)}")
        self.kind, self.num_col = kind, int(num_col)
        self.names = tuple(str(s[0]) for s in layout)
        segs = []
        for name, dtype_str, off, nbytes, shape in layout:
            dt = torch_dtype(dtype_str)
            shape = tuple(int(d) for d in shape)
            size = _itemsize(dt)
            check(int(off) >= 0 and int(nbytes) == int(np.prod(shape, dtype=np.int64)) * size,
                  f"decode: segment {name} of {nbytes} bytes at {off} is no {dtype_str} {shape}")
            segs.append((dt, size, int(off), int(nbytes), shape))
        self.span_bytes = max((off + n for _, _, off, n, _ in segs), default=0)
        self.out_bytes = 0
        self.aux = None
        self.table = DecodeTable()
        self.outputs: tuple = ()
        if kind == "dense_packed_q8":
            self._plan_q8(segs)
        elif kind == "dense_packed" and segs[0][0] == torch.bfloat16:
            self._plan_bf16_aux(segs[0])
        else:
            self._plan_copies(segs)
        in_out = [o for o in self.outputs if o[0]]
        self.direct = ((in_out[0][3], in_out[0][5])
                       if len(in_out) == 1 and self.aux is None else None)
        self.table_ptr = ctypes.addressof(self.table)

    def _alloc(self, nbytes: int) -> int:
        off = self.out_bytes
        self.out_bytes = _round16(off + nbytes)
        return off

    def _add_op(self, op: int, src: int, dst: int, rows: int, cols: int,
                extra: int, out_bytes: int) -> None:
        check(rows * cols < 1 << 31, f"decode: a slab of {rows}x{cols} is too large a segment")
        if rows * cols == 0:
            return
        t = self.table
        t.ops[t.count] = _Op(op, 0, src, dst, rows, cols, extra, t.blocks)
        t.count += 1
        t.blocks += -(-out_bytes // (_VEC * _THREADS))

    def _check_packed(self, shape) -> Tuple[int, int]:
        check(len(shape) == 2 and shape[1] == self.num_col + 2,
              f"decode: a packed dense slab {shape} is not [B, num_col + 2] "
              f"with num_col {self.num_col}")
        return shape

    def _plan_q8(self, segs) -> None:
        (qdt, _, qoff, _, qshape), (sdt, _, soff, _, sshape) = segs
        check(qdt == torch.int8 and sdt == torch.float32 and sshape == qshape[-1:],
              "decode: a dense_packed_q8 batch is int8 [B, C] and a float32 [C] scale")
        rows, cols = self._check_packed(qshape)
        dst = self._alloc(rows * cols * 4)
        self._add_op(OP_DEQUANT_Q8, qoff, dst, rows, cols, soff, rows * cols * 4)
        self.outputs = ((True, dst, rows * cols * 4, torch.float32, 4, qshape, (cols, 1)),)

    def _plan_bf16_aux(self, seg) -> None:
        _, _, off, nbytes, shape = seg
        rows, cols = self._check_packed(shape)
        dst = self._alloc(nbytes)
        aux = self._alloc(2 * rows * 4)
        self._add_op(OP_BF16_AUX, off, dst, rows, cols, aux, nbytes)
        self.outputs = ((True, dst, nbytes, torch.bfloat16, 2, shape, (cols, 1)),)
        self.aux = (aux, 2 * rows * 4, torch.float32, 4, (2, rows))

    def _plan_copies(self, segs) -> None:
        if self.kind == "dense_packed":
            self._check_packed(segs[0][4])
        outputs = []
        for dt, size, off, nbytes, shape in segs:
            strides = tuple(int(np.prod(shape[i + 1:], dtype=np.int64))
                            for i in range(len(shape)))
            if len(shape) == 2 and dt in _WIDE:
                dst = self._alloc(nbytes)
                op = OP_COPY4 if dt == torch.float32 else OP_COPY2
                self._add_op(op, off, dst, shape[0], shape[1], 0, nbytes)
                outputs.append((True, dst, nbytes, dt, size, shape, strides))
            else:
                outputs.append((False, off, nbytes, dt, size, shape, strides))
        self.outputs = tuple(outputs)

    def assemble(self, span: torch.Tensor, out: torch.Tensor):
        """The batch over ``span`` and the filled output allocation. A
        span view is carved from one typed view of the whole span per dtype
        where the span's start and length allow it (a snapshot's always
        do), else from its own slice."""
        base, numel = span.storage_offset(), span.numel()
        whole: Dict[torch.dtype, torch.Tensor] = {}
        arrays = []
        for in_out, off, n, dt, size, shape, strides in self.outputs:
            if in_out:
                arrays.append(out if self.direct else _typed(out, off, n, dt, size, shape, 0))
            elif (base | numel | off) % size:  # item sizes are powers of two
                arrays.append(_typed(span, off, n, dt, size, shape, base))
            else:
                view = whole.get(dt)
                if view is None:
                    view = whole[dt] = span.view(dt)
                arrays.append(view.as_strided(shape, strides, (base + off) // size))
        if self.kind == SEGMENTS:
            return dict(zip(self.names, arrays))
        if self.kind == "ell":
            return EllBatch(*arrays)
        if self.kind == "dense":
            return tuple(arrays)
        aux = None if self.aux is None else _typed(out, *self.aux, 0)
        return PackedDenseBatch(arrays[0], self.num_col, aux)


def _itemsize(dt: torch.dtype) -> int:
    return torch.empty((), dtype=dt).element_size()


def _typed(buf: torch.Tensor, off: int, nbytes: int, dt: torch.dtype, size: int,
           shape, base: int) -> torch.Tensor:
    """``buf[off: off + nbytes]`` as ``dt`` (of ``size`` bytes) in ``shape``;
    ``base`` is ``buf``'s storage offset. torch views only a segment whose
    start is a multiple of the item size; one that is not (in a span that
    does not itself start aligned, which no snapshot gives) is copied
    first."""
    seg = buf[off: off + nbytes]
    if (base + off) % size:
        seg = seg.clone()
    seg = seg.view(dt)
    return seg if len(shape) == 1 else seg.view(shape)


_PLANS: Dict[tuple, DecodePlan] = {}


def plan_for(kind: str, layout: Layout, num_col: int = 0) -> DecodePlan:
    """The cached :class:`DecodePlan` of ``(kind, layout, num_col)``, built
    on first use; raises :class:`DMLCError` on a layout no plan takes."""
    key = (kind, layout, num_col)
    plan = _PLANS.get(key)
    if plan is None:
        plan = DecodePlan(kind, layout, num_col)
        if len(_PLANS) >= _MAX_PLANS:
            _PLANS.pop(next(iter(_PLANS)), None)
        _PLANS[key] = plan
    return plan


# ---------------- the kernel route ----------------

def _launch(span: torch.Tensor, plan: DecodePlan):
    """One launch of K2 for ``plan`` on the current stream; returns the
    plan's batch."""
    global launches
    check(span.is_cuda, "decode: the span must be on a CUDA device")
    check(span.dtype == torch.uint8 and span.dim() == 1 and span.is_contiguous()
          and span.numel() >= plan.span_bytes,
          f"decode: needs a contiguous 1-D uint8 span of at least {plan.span_bytes} bytes")
    dev = span.device
    if plan.direct is not None:
        out = torch.empty(plan.direct[1], dtype=plan.direct[0], device=dev)
    else:
        out = torch.empty(plan.out_bytes, dtype=torch.uint8, device=dev)
    if plan.table.count:
        lib = _build.load_kernels()
        stream = torch.cuda.current_stream(dev)
        if dev.index == torch.cuda.current_device():
            rc = lib.dmlc_decode_span(span.data_ptr(), out.data_ptr(), plan.table_ptr,
                                      stream.cuda_stream)
        else:
            with torch.cuda.device(dev):
                rc = lib.dmlc_decode_span(span.data_ptr(), out.data_ptr(), plan.table_ptr,
                                          stream.cuda_stream)
        if rc != 0:
            raise DMLCError("decode kernel launch failed: "
                            + lib.dmlc_cuda_error_string(rc).decode())
        launches += 1
    return plan.assemble(span, out)


def decode_batch_cuda(span: torch.Tensor, layout: Layout, kind: str, num_col: int = 0):
    """The batch of ``kind`` in a CUDA u8 span, in one launch of K2 on the
    current stream; raises on a CPU span."""
    return _launch(span, plan_for(kind, layout, num_col))


def decode_batch_plain(span: torch.Tensor, layout: Layout, kind: str, num_col: int = 0):
    """The plain version of :func:`decode_batch`: each segment through
    :func:`widen_span_plain` or a view, then :func:`wrap_batch`."""
    segs = _decode_span_plain(span, layout)
    return wrap_batch(kind, [segs[name] for name, *_ in layout], num_col)


def decode_batch(span: torch.Tensor, layout: Layout, kind: str, num_col: int = 0):
    """The batch of ``kind`` (an ``EllBatch``, a :class:`PackedDenseBatch`
    or ``(x, y, w)``) held in a u8 span laid out by ``layout``: one K2
    launch on the current stream for a CUDA span, the plain version for a
    CPU one."""
    plan = plan_for(kind, layout, num_col)
    if span.is_cuda:
        return _launch(span, plan)
    return decode_batch_plain(span, layout, kind, num_col)


# ---------------- one segment, and decode_span ----------------

def _check_segment(seg: torch.Tensor, rows: int, cols: int, dtype: torch.dtype) -> int:
    check(dtype in _WIDE, f"widen_span: dtype {dtype} is not float32 or bfloat16")
    check(seg.dtype == torch.uint8 and seg.dim() == 1,
          f"widen_span: needs a 1-D uint8 segment, got {seg.dtype} {tuple(seg.shape)}")
    k = _itemsize(dtype)
    check(seg.numel() == rows * cols * k,
          f"widen_span: segment of {seg.numel()} bytes is not {rows}x{cols}x{k}")
    return k


def widen_span_plain(seg: torch.Tensor, rows: int, cols: int,
                     dtype: torch.dtype) -> torch.Tensor:
    """The plain version of K2's slab copy, with the TPU kernel's
    arithmetic: split the ``[rows, cols, k]`` byte planes, join them with
    shift/or in int64, mask to the word, narrow to the signed word type and
    view as ``dtype``."""
    k = _check_segment(seg, rows, cols, dtype)
    planes = seg.reshape(rows, cols, k).to(torch.int64)
    bits = torch.zeros((rows, cols), dtype=torch.int64, device=seg.device)
    for j in range(k):
        bits |= planes[:, :, j] << (8 * j)
    width = 8 * k
    bits &= (1 << width) - 1
    # the top plane shifted by 24 (or 8) sets the word's sign bit: fold the
    # unsigned word into the signed range before narrowing
    bits = torch.where(bits >= 1 << (width - 1), bits - (1 << width), bits)
    return bits.to(_WIDE[dtype]).view(dtype)


def widen_span_cuda(seg: torch.Tensor, rows: int, cols: int,
                    dtype: torch.dtype) -> torch.Tensor:
    """One ``[rows, cols]`` f32/bf16 slab from a contiguous 1-D uint8 CUDA
    segment of ``rows * cols * itemsize`` bytes, in one launch of K2 (a
    one-entry plan) on the current stream; raises on anything else."""
    check(seg.is_cuda, "widen_span_cuda: the segment must be on a CUDA device")
    nbytes = _check_segment(seg, rows, cols, dtype) * rows * cols
    layout = (("a0", _DTYPE_STR[dtype], 0, nbytes, (rows, cols)),)
    return _launch(seg, plan_for(SEGMENTS, layout))["a0"]


def widen_span(seg: torch.Tensor, rows: int, cols: int,
               dtype: torch.dtype) -> torch.Tensor:
    """K2 on one segment: the kernel for a CUDA segment, the plain version
    for a CPU one."""
    if seg.is_cuda:
        return widen_span_cuda(seg, rows, cols, dtype)
    return widen_span_plain(seg, rows, cols, dtype)


def _decode_span_plain(span: torch.Tensor, layout: Layout) -> Dict[str, torch.Tensor]:
    base = span.storage_offset()
    out: Dict[str, torch.Tensor] = {}
    for name, dtype_str, off, nbytes, shape in layout:
        dt = torch_dtype(dtype_str)
        if len(shape) == 2 and dt in _WIDE:
            out[name] = widen_span_plain(span[off: off + nbytes], shape[0], shape[1], dt)
        else:
            out[name] = _typed(span, off, nbytes, dt, _itemsize(dt), shape, base)
    return out


def decode_span(span: torch.Tensor, layout: Layout) -> Dict[str, torch.Tensor]:
    """{segment name: typed tensor} for a u8 span holding one batch's
    ``[pos, end)`` bytes, per its ``layout``
    (:func:`dmlc_tpu_torch.io.block_cache.span_layout`): 2-D float32 and
    bfloat16 segments copied by K2 (one launch for all of them) on a CUDA
    span and by :func:`widen_span_plain` on a CPU one, the others views of
    ``span``."""
    check(span.dtype == torch.uint8 and span.dim() == 1,
          "decode_span: needs a 1-D uint8 span")
    plan = plan_for(SEGMENTS, layout)
    if span.is_cuda:
        return _launch(span, plan)
    return _decode_span_plain(span, layout)
