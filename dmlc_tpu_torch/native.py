"""ctypes binding of the C++ chunk parsers, built on demand with g++.

The sources are the repository's ``native/src/*.cc`` (the same list and flags
the JAX package builds with), compiled by this port into its own
``dmlc_tpu_torch/_build/`` — never into ``native/build/``, which the JAX
package owns and rebuilds on its own schedule. Bound here: the chunk
scanners ``dmlc_parse_libsvm`` and ``dmlc_parse_libfm`` (CSR blocks),
``dmlc_parse_libsvm_dense`` (libsvm straight to the dense layout; a qid
row raises :class:`NeedsCsrError`) and ``dmlc_parse_csv`` (a float32 cell
matrix); and the fused stream reader ``dmlc_reader_*`` (``reader.cc``: a
C++ producer thread reads record-aligned chunks of a byte-range partition
of local files and parses them on worker threads, :class:`Reader`), whose
results are tagged with a ``FMT_*`` code; its push mode ``dmlc_feeder_*``
(:class:`Feeder`: the caller pushes a partition's bytes from any
filesystem), the indexed RecordIO reader ``dmlc_indexed_reader_*``
(:class:`IndexedReader`), the RecordIO framing scan
``dmlc_recordio_extract`` (:func:`recordio_extract`) and the chunk-batch
parser ``dmlc_parse_batch`` (:func:`parse_batch`: a chunk straight to a
block-cache segment span). The ctypes structs mirror the JAX package's
(``dmlc_tpu/native/__init__.py``). A chunk is bytes or a memoryview
(an mmap slice), whose buffer address is passed through with no copy.
Result arrays are wrapped as numpy views that own the malloc'd buffers
through a finalizer (zero copies on the handoff). A bfloat16 payload (the
reader's dense repack with ``out_bf16``) is wrapped as a ``uint16`` view
of its bits: numpy has no bfloat16 type, and the device side reinterprets
it as ``torch.bfloat16``.

As in the reference, a failed build logs a warning and :func:`available`
is False: the parsers then use the numpy engine, which emits identical
blocks.
"""

from __future__ import annotations

import ctypes
import os
import threading
import weakref
from typing import Optional

import numpy as np

from dmlc_tpu_torch.ops._build import PKG_DIR, ensure_built
from dmlc_tpu_torch.utils.check import DMLCError, get_logger

_SRC_DIR = os.path.join(os.path.dirname(PKG_DIR), "native", "src")
_SRCS = [os.path.join(_SRC_DIR, f)
         for f in ("parse.cc", "reader.cc", "recordio.cc", "batch_parse.cc")]
_HDRS = [os.path.join(_SRC_DIR, f)
         for f in ("api.h", "strtonum.h", "parse_internal.h", "buffer_pool.h")]
_LIB_NAME = "libdmlc_torch_native.so"
_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-pthread", "-D_FILE_OFFSET_BITS=64"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False
# seconds the build took in this process (0.0: the library was fresh)
build_seconds: Optional[float] = None


class NeedsCsrError(DMLCError):
    """Input the dense scanner cannot express (qid rows): the explicit
    signal (``DenseResult.needs_csr``) for callers to take the CSR path, so
    no routing depends on an error message's wording."""


class _CsrBlockResult(ctypes.Structure):
    _fields_ = [
        ("n_rows", ctypes.c_int64),
        ("nnz", ctypes.c_int64),
        ("offset", ctypes.POINTER(ctypes.c_int64)),
        ("label", ctypes.POINTER(ctypes.c_float)),
        ("weight", ctypes.POINTER(ctypes.c_float)),
        ("qid", ctypes.POINTER(ctypes.c_int64)),
        ("index", ctypes.POINTER(ctypes.c_uint64)),
        ("field", ctypes.POINTER(ctypes.c_uint64)),
        ("value", ctypes.POINTER(ctypes.c_float)),
        ("error", ctypes.c_char_p),
    ]


class _DenseResult(ctypes.Structure):
    _fields_ = [
        ("n_rows", ctypes.c_int64),
        ("n_cols", ctypes.c_int64),
        ("x", ctypes.POINTER(ctypes.c_float)),
        ("label", ctypes.POINTER(ctypes.c_float)),
        ("weight", ctypes.POINTER(ctypes.c_float)),
        ("error", ctypes.c_char_p),
        ("needs_csr", ctypes.c_int32),
        ("x_bf16", ctypes.c_int32),
        ("packed_aux", ctypes.c_int32),
    ]


class _CsvResult(ctypes.Structure):
    _fields_ = [
        ("n_rows", ctypes.c_int64),
        ("n_cols", ctypes.c_int64),
        ("cells", ctypes.POINTER(ctypes.c_float)),
        ("error", ctypes.c_char_p),
    ]


class _CsvSplitResult(ctypes.Structure):
    _fields_ = [
        ("n_rows", ctypes.c_int64),
        ("n_feat_cols", ctypes.c_int64),
        ("values", ctypes.POINTER(ctypes.c_float)),
        ("label", ctypes.POINTER(ctypes.c_float)),
        ("weight", ctypes.POINTER(ctypes.c_float)),
        ("error", ctypes.c_char_p),
    ]


class _SegmentBlockResult(ctypes.Structure):
    _fields_ = [
        ("n_rows", ctypes.c_int64),
        ("nnz", ctypes.c_int64),
        ("num_col", ctypes.c_int64),
        ("buf", ctypes.POINTER(ctypes.c_char)),
        ("buf_len", ctypes.c_int64),
        ("seg_off", ctypes.c_int64 * 7),
        ("seg_len", ctypes.c_int64 * 7),
        ("crc32", ctypes.c_uint32),
        ("simd_level", ctypes.c_int32),
        ("error", ctypes.c_char_p),
    ]


class _RecordBatchResult(ctypes.Structure):
    _fields_ = [
        ("n_records", ctypes.c_int64),
        ("data_len", ctypes.c_int64),
        ("data", ctypes.POINTER(ctypes.c_char)),
        ("offsets", ctypes.POINTER(ctypes.c_int64)),
        ("error", ctypes.c_char_p),
    ]


class _CooResult(ctypes.Structure):
    _fields_ = [
        ("n_rows", ctypes.c_int64),
        ("nnz", ctypes.c_int64),
        ("rows_padded", ctypes.c_int64),
        ("nnz_padded", ctypes.c_int64),
        ("coords", ctypes.POINTER(ctypes.c_int32)),
        ("values", ctypes.POINTER(ctypes.c_float)),
        ("label", ctypes.POINTER(ctypes.c_float)),
        ("weight", ctypes.POINTER(ctypes.c_float)),
        ("error", ctypes.c_char_p),
        ("values_elided", ctypes.c_int32),
        ("csr_wire", ctypes.c_int32),
        ("row_ptr", ctypes.POINTER(ctypes.c_int32)),
    ]


def _commands(out_path: str, obj_dir: str):
    # one g++ per source, all started together, then one link
    objs = [os.path.join(obj_dir, os.path.basename(s) + ".o") for s in _SRCS]
    compile_cmds = [["g++"] + _FLAGS + ["-c", src, "-o", obj]
                    for src, obj in zip(_SRCS, objs)]
    return compile_cmds, ["g++", "-shared", "-pthread", "-o", out_path] + objs


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed, build_seconds
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            path, build_seconds, _ = ensure_built(_LIB_NAME, _SRCS + _HDRS, _commands)
            lib = ctypes.CDLL(path)
        except (DMLCError, OSError) as exc:
            get_logger().warning("native parser build failed; using the numpy "
                                 "engine: %s", str(exc)[-2000:])
            _build_failed = True
            return None
        for name in ("dmlc_parse_libsvm", "dmlc_parse_libfm"):
            fn = getattr(lib, name)
            fn.restype = ctypes.POINTER(_CsrBlockResult)
            fn.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int]
        lib.dmlc_parse_libsvm_dense.restype = ctypes.POINTER(_DenseResult)
        lib.dmlc_parse_libsvm_dense.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int64, ctypes.c_int]
        lib.dmlc_parse_csv.restype = ctypes.POINTER(_CsvResult)
        lib.dmlc_parse_csv.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_char]
        # void* so the finalizers never depend on ctypes class identity
        for name in ("dmlc_free_block", "dmlc_free_dense", "dmlc_free_csv",
                     "dmlc_free_csv_split", "dmlc_free_coo", "dmlc_free_segblock",
                     "dmlc_free_records"):
            getattr(lib, name).argtypes = [ctypes.c_void_p]
        lib.dmlc_reader_create.restype = ctypes.c_void_p
        lib.dmlc_reader_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int32, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int64, ctypes.c_int32, ctypes.c_char, ctypes.c_int32,
            ctypes.c_int64, ctypes.c_int32, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32]
        lib.dmlc_reader_next.restype = ctypes.c_void_p
        lib.dmlc_reader_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32)]
        lib.dmlc_reader_before_first.argtypes = [ctypes.c_void_p]
        lib.dmlc_reader_bytes_read.restype = ctypes.c_int64
        lib.dmlc_reader_bytes_read.argtypes = [ctypes.c_void_p]
        lib.dmlc_reader_error.restype = ctypes.c_char_p
        lib.dmlc_reader_error.argtypes = [ctypes.c_void_p]
        lib.dmlc_reader_destroy.argtypes = [ctypes.c_void_p]
        lib.dmlc_parse_batch.restype = ctypes.POINTER(_SegmentBlockResult)
        lib.dmlc_parse_batch.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_char, ctypes.c_int32, ctypes.c_int32]
        lib.dmlc_simd_level.restype = ctypes.c_int
        lib.dmlc_recordio_extract.restype = ctypes.POINTER(_RecordBatchResult)
        lib.dmlc_recordio_extract.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        lib.dmlc_feeder_create.restype = ctypes.c_void_p
        lib.dmlc_feeder_create.argtypes = [
            ctypes.c_int32, ctypes.c_int64, ctypes.c_int32, ctypes.c_char,
            ctypes.c_int32, ctypes.c_int64, ctypes.c_int32, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32]
        lib.dmlc_feeder_push.restype = ctypes.c_int32
        lib.dmlc_feeder_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64]
        lib.dmlc_feeder_fail.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.dmlc_feeder_next.restype = ctypes.c_void_p
        lib.dmlc_feeder_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32)]
        lib.dmlc_feeder_bytes_read.restype = ctypes.c_int64
        lib.dmlc_feeder_error.restype = ctypes.c_char_p
        for name in ("dmlc_feeder_finish", "dmlc_feeder_abort", "dmlc_feeder_before_first",
                     "dmlc_feeder_bytes_read", "dmlc_feeder_error", "dmlc_feeder_destroy"):
            getattr(lib, name).argtypes = [ctypes.c_void_p]
        lib.dmlc_indexed_reader_create.restype = ctypes.c_void_p
        lib.dmlc_indexed_reader_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int32, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_uint64, ctypes.c_int32]
        lib.dmlc_indexed_reader_next.restype = ctypes.c_void_p
        lib.dmlc_indexed_reader_skip.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                                 ctypes.c_int64]
        lib.dmlc_indexed_reader_bytes_read.restype = ctypes.c_int64
        lib.dmlc_indexed_reader_error.restype = ctypes.c_char_p
        for name in ("dmlc_indexed_reader_next", "dmlc_indexed_reader_before_first",
                     "dmlc_indexed_reader_bytes_read", "dmlc_indexed_reader_error",
                     "dmlc_indexed_reader_destroy"):
            getattr(lib, name).argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def default_nthread() -> int:
    """min(user, cores/2) in the spirit of text_parser.h:33-34."""
    env = os.environ.get("DMLC_TPU_PARSE_THREADS")
    if env:
        return max(1, int(env))
    return max(2, (os.cpu_count() or 2) // 2)


class _Owner:
    """Frees the C result with ``free_fn`` when garbage collected."""

    __slots__ = ("__weakref__",)

    def __init__(self, free_fn, res):
        weakref.finalize(self, free_fn, ctypes.cast(res, ctypes.c_void_p).value)


class _HeldBuffer:
    """Array-interface shim: ``np.asarray`` on it is a zero-copy view whose
    base chain pins the owner, so the buffer lives as long as any view."""

    __slots__ = ("owner", "__array_interface__")

    def __init__(self, addr: int, nbytes: int, owner):
        self.owner = owner
        self.__array_interface__ = {
            "data": (addr, False), "shape": (nbytes,), "typestr": "|u1",
            "version": 3,
        }


def _view(ptr, n, dtype, owner):
    if not ptr or n == 0:
        return None
    dtype = np.dtype(dtype)
    addr = ctypes.cast(ptr, ctypes.c_void_p).value
    return np.asarray(_HeldBuffer(addr, n * dtype.itemsize, owner)).view(dtype)


def _chunk_buf(chunk):
    """``bytes | memoryview`` -> (a ``c_char_p`` argument, its length, a
    keepalive). A contiguous view passes its buffer address with no copy:
    every native scanner reads ``[data, data + len)`` only and copies what
    it keeps. The keepalive must stay referenced until the call returns."""
    if isinstance(chunk, bytes):
        return chunk, len(chunk), chunk
    view = memoryview(chunk)
    if view.nbytes == 0 or not view.c_contiguous:
        data = bytes(view)
        return data, len(data), data
    arr = np.frombuffer(view, np.uint8)
    return ctypes.c_char_p(arr.ctypes.data), arr.nbytes, (view, arr)


def _wrap_block(lib, res) -> dict:
    r = res.contents
    if r.error:
        msg = r.error.decode()
        lib.dmlc_free_block(res)
        raise DMLCError(msg)
    owner = _Owner(lib.dmlc_free_block, res)
    n, nnz = r.n_rows, r.nnz
    out = {
        "offset": _view(r.offset, n + 1, np.int64, owner),
        "label": _view(r.label, n, np.float32, owner),
        "weight": _view(r.weight, n, np.float32, owner),
        "qid": _view(r.qid, n, np.int64, owner),
        "index": _view(r.index, nnz, np.uint64, owner),
        "field": _view(r.field, nnz, np.uint64, owner),
        "value": _view(r.value, nnz, np.float32, owner),
        "_owner": owner,
    }
    if n == 0:
        out["offset"] = np.zeros(1, np.int64)
        out["label"] = np.empty(0, np.float32)
    if out["index"] is None:
        out["index"] = np.empty(0, np.uint64)
    return out


def parse_libsvm(chunk, nthread: int = 0, indexing_mode: int = 0):
    """Parse a libsvm chunk natively; a dict of numpy arrays, or None when
    the native library is unavailable. Malformed input raises DMLCError."""
    lib = _load()
    if lib is None:
        return None
    buf, n, keep = _chunk_buf(chunk)
    res = lib.dmlc_parse_libsvm(buf, n, nthread or default_nthread(), indexing_mode)
    del keep
    return _wrap_block(lib, res)


def parse_libfm(chunk, nthread: int = 0, indexing_mode: int = 0):
    """Parse a libfm chunk natively (``field`` filled); as :func:`parse_libsvm`."""
    lib = _load()
    if lib is None:
        return None
    buf, n, keep = _chunk_buf(chunk)
    res = lib.dmlc_parse_libfm(buf, n, nthread or default_nthread(), indexing_mode)
    del keep
    return _wrap_block(lib, res)


def parse_libsvm_dense(chunk, num_col: int, nthread: int = 0, indexing_mode: int = -1):
    """Parse libsvm straight to the dense layout: ``(x [n, num_col] float32,
    label, weight or None, owner)``, or None when the native library is
    unavailable. Features at or past ``num_col`` are dropped. Raises
    :class:`NeedsCsrError` for input the dense scanner cannot express (qid
    rows), DMLCError for malformed input."""
    lib = _load()
    if lib is None:
        return None
    buf, n, keep = _chunk_buf(chunk)
    res = lib.dmlc_parse_libsvm_dense(buf, n, nthread or default_nthread(), num_col,
                                      indexing_mode)
    del keep
    return _wrap_dense(lib, res, num_col)[:4]


def _wrap_dense(lib, res, num_col: int):
    """A DenseResult as ``(x, label, weight, owner, packed)``. A bfloat16
    ``x`` is a ``uint16`` view of its bits. ``packed``: ``x`` is ``[n,
    num_col + 2]`` with label and weight as its trailing columns, and
    ``label``/``weight`` are views of those columns (in ``x``'s dtype)."""
    r = res.contents
    if r.error:
        msg = r.error.decode()
        needs_csr = bool(r.needs_csr)
        lib.dmlc_free_dense(res)
        raise NeedsCsrError(msg) if needs_csr else DMLCError(msg)
    owner = _Owner(lib.dmlc_free_dense, res)
    rows = r.n_rows
    x_dtype = np.uint16 if r.x_bf16 else np.float32
    if rows == 0:
        return (np.zeros((0, num_col), x_dtype), np.empty(0, np.float32), None,
                owner, False)
    if r.packed_aux:
        xp = _view(r.x, rows * (num_col + 2), x_dtype, owner).reshape(rows, num_col + 2)
        return xp, xp[:, num_col], xp[:, num_col + 1], owner, True
    x = _view(r.x, rows * num_col, x_dtype, owner)
    x = np.zeros((rows, num_col), x_dtype) if x is None else x.reshape(rows, num_col)
    return (x, _view(r.label, rows, np.float32, owner),
            _view(r.weight, rows, np.float32, owner), owner, False)


def parse_csv(chunk, delimiter: str = ",", nthread: int = 0):
    """Parse a csv chunk natively: ``(cells [n, ncol] float32, owner)``, or
    None when the native library is unavailable. The caller keeps
    ``owner`` referenced while it uses ``cells``."""
    lib = _load()
    if lib is None:
        return None
    buf, n, keep = _chunk_buf(chunk)
    res = lib.dmlc_parse_csv(buf, n, nthread or default_nthread(),
                             delimiter.encode()[0] if delimiter else b","[0])
    del keep
    return _wrap_csv(lib, res)


def _wrap_csv_split(lib, res):
    """``(values [n, k], label or None, weight or None, n, owner)``, views
    over the C buffers; the caller supplies the csv skeleton (index,
    offset)."""
    r = res.contents
    if r.error:
        msg = r.error.decode()
        lib.dmlc_free_csv_split(res)
        raise DMLCError(msg)
    owner = _Owner(lib.dmlc_free_csv_split, res)
    n, k = r.n_rows, r.n_feat_cols
    if n == 0:
        return np.zeros((0, 0), np.float32), None, None, 0, owner
    values = (_view(r.values, n * k, np.float32, owner).reshape(n, k)
              if k else np.zeros((n, 0), np.float32))
    return (values, _view(r.label, n, np.float32, owner),
            _view(r.weight, n, np.float32, owner), int(n), owner)


def _wrap_csv(lib, res):
    r = res.contents
    if r.error:
        msg = r.error.decode()
        lib.dmlc_free_csv(res)
        raise DMLCError(msg)
    owner = _Owner(lib.dmlc_free_csv, res)
    rows, cols = r.n_rows, r.n_cols
    if rows == 0 or cols == 0:
        return np.zeros((0, 0), np.float32), owner
    return _view(r.cells, rows * cols, np.float32, owner).reshape(rows, cols), owner


# canonical segment slot order: io/block_cache.py's SEGMENT_NAMES and the
# native DMLC_SEG_* constants, with the on-disk dtypes
_BATCH_SEGMENTS = (
    ("offset", "<i8"), ("label", "<f4"), ("weight", "<f4"), ("qid", "<i8"),
    ("field", "<u8"), ("index", "<u8"), ("value", "<f4"),
)

# dmlc_parse_batch format codes (the stream reader's FMT_* values)
BATCH_FMT = {"libsvm": 0, "csv": 2, "libfm": 3}


def simd_level() -> int:
    """The batch scanner's scan ISA on this host: 0 scalar, 1 SSE2, 2 AVX2,
    3 NEON; -1 when the native library is unavailable."""
    lib = _load()
    return -1 if lib is None else int(lib.dmlc_simd_level())


def parse_batch(chunk, fmt: str, nthread: int = 0, indexing_mode: int = 0,
                delimiter: str = ",", label_col: int = -1, weight_col: int = -1):
    """Parse a whole text chunk straight into a block-cache v1 segment span
    (``native/src/batch_parse.cc``). None when the native library is
    unavailable, else a dict:

    - ``segments``: ``{name: view}`` of the present arrays, what
      ``RowBlock.from_segments`` takes;
    - ``data``: one uint8 view over the whole span, the bytes a block-cache
      block stores;
    - ``arrays``: ``{name: [dtype_str, span_offset, nbytes]}``, the footer
      schema with offsets relative to ``data``;
    - ``rows``, ``nnz``, ``num_col``, ``crc`` (zlib's crc32 of ``data``),
      ``simd_level`` and ``_owner`` (keep it referenced while a view lives).

    Malformed input raises DMLCError.
    """
    lib = _load()
    if lib is None:
        return None
    code = BATCH_FMT.get(fmt)
    if code is None:
        raise DMLCError(f"parse_batch: unsupported format {fmt!r}")
    buf, n, keep = _chunk_buf(chunk)
    res = lib.dmlc_parse_batch(buf, n, nthread or default_nthread(), code, indexing_mode,
                               delimiter.encode()[0] if delimiter else b","[0],
                               label_col, weight_col)
    del keep
    if not res:
        raise DMLCError("batch parse: out of memory")
    r = res.contents
    if r.error:
        msg = r.error.decode()
        lib.dmlc_free_segblock(res)
        raise DMLCError(msg)
    owner = _Owner(lib.dmlc_free_segblock, res)
    rows = int(r.n_rows)
    out = {"rows": rows, "nnz": int(r.nnz), "num_col": int(r.num_col), "crc": int(r.crc32),
           "simd_level": int(r.simd_level), "segments": {}, "arrays": {}, "data": None,
           "_owner": owner}
    if rows == 0:
        return out
    span = _view(r.buf, int(r.buf_len), np.uint8, owner)
    out["data"] = span if span is not None else np.empty(0, np.uint8)
    for slot, (name, dtype_str) in enumerate(_BATCH_SEGMENTS):
        off = int(r.seg_off[slot])
        if off < 0:
            continue
        nbytes = int(r.seg_len[slot])
        dt = np.dtype(dtype_str)
        # a present but empty segment (a label-only chunk's index) is a
        # real footer entry, as the segment writer records it
        out["segments"][name] = (out["data"][off: off + nbytes].view(dt) if nbytes
                                 else np.empty(0, dt))
        out["arrays"][name] = [dtype_str, off, nbytes]
    return out


def recordio_extract(data):
    """Every record of a span of RecordIO bytes that starts at a record
    head and holds whole records: ``(payload uint8, offsets int64 [n+1])``,
    record ``i`` being ``payload[offsets[i]:offsets[i+1]]``, views over the
    native buffer. None when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    data = bytes(data) if not isinstance(data, bytes) else data
    res = lib.dmlc_recordio_extract(data, len(data))
    if not res:
        raise DMLCError("recordio: out of memory")
    return _wrap_records(lib, res)


def _wrap_records(lib, res):
    r = res.contents
    if r.error:
        msg = r.error.decode()
        lib.dmlc_free_records(res)
        raise DMLCError(msg)
    owner = _Owner(lib.dmlc_free_records, res)
    n = r.n_records
    offsets = _view(r.offsets, n + 1, np.int64, owner)
    payload = _view(r.data, r.data_len, np.uint8, owner)
    if offsets is None:
        offsets = np.zeros(1, np.int64)
    if payload is None:
        payload = np.empty(0, np.uint8)
    return payload, offsets


# ---------------- the fused stream reader (reader.cc) ----------------

FMT_LIBSVM = 0
FMT_LIBSVM_DENSE = 1
FMT_CSV = 2
FMT_LIBFM = 3
FMT_RECORDIO = 4
FMT_RECORDIO_CHUNK = 5
FMT_LIBSVM_COO = 6
FMT_LIBFM_COO = 7
FMT_CSV_SPLIT = 8


def _wrap_coo(lib, res) -> dict:
    """A CooResult as a dict of views: ``coords`` int32 ``[nnz_padded, 2]``
    (row, col), or on the CSR wire the columns alone ``[nnz_padded]`` with
    ``row_ptr`` int32 ``[rows_padded + 1]``; ``values`` None when elided;
    ``n_rows``/``nnz`` the real counts (the shapes carry the bucket pad)."""
    r = res.contents
    if r.error:
        msg = r.error.decode()
        lib.dmlc_free_coo(res)
        raise DMLCError(msg)
    owner = _Owner(lib.dmlc_free_coo, res)
    if r.csr_wire:
        coords = _view(r.coords, r.nnz_padded, np.int32, owner)
        coords = coords if coords is not None else np.zeros((0,), np.int32)
        row_ptr = _view(r.row_ptr, r.rows_padded + 1, np.int32, owner)
    else:
        coords = _view(r.coords, 2 * r.nnz_padded, np.int32, owner)
        coords = (coords.reshape(r.nnz_padded, 2) if coords is not None
                  else np.zeros((0, 2), np.int32))
        row_ptr = None
    return {"n_rows": int(r.n_rows), "nnz": int(r.nnz),
            "rows_padded": int(r.rows_padded), "coords": coords, "row_ptr": row_ptr,
            "values": (None if r.values_elided
                       else _view(r.values, r.nnz_padded, np.float32, owner)),
            "label": _view(r.label, r.rows_padded, np.float32, owner),
            "weight": _view(r.weight, r.rows_padded, np.float32, owner),
            "_owner": owner}


def _wrap_stream_result(lib, ptr, fmt_value: int, num_col: int):
    """A ``dmlc_reader_next`` / ``dmlc_feeder_next`` result, wrapped by
    its format tag: ``(fmt, wrapped)``."""
    if fmt_value in (FMT_LIBSVM, FMT_LIBFM):
        return fmt_value, _wrap_block(lib, ctypes.cast(ptr, ctypes.POINTER(_CsrBlockResult)))
    if fmt_value == FMT_LIBSVM_DENSE:
        return fmt_value, _wrap_dense(lib, ctypes.cast(ptr, ctypes.POINTER(_DenseResult)),
                                      num_col)
    if fmt_value in (FMT_RECORDIO, FMT_RECORDIO_CHUNK):
        return fmt_value, _wrap_records(
            lib, ctypes.cast(ptr, ctypes.POINTER(_RecordBatchResult)))
    if fmt_value in (FMT_LIBSVM_COO, FMT_LIBFM_COO):
        return fmt_value, _wrap_coo(lib, ctypes.cast(ptr, ctypes.POINTER(_CooResult)))
    if fmt_value == FMT_CSV_SPLIT:
        return fmt_value, _wrap_csv_split(
            lib, ctypes.cast(ptr, ctypes.POINTER(_CsvSplitResult)))
    if fmt_value == FMT_CSV:
        return fmt_value, _wrap_csv(lib, ctypes.cast(ptr, ctypes.POINTER(_CsvResult)))
    raise DMLCError(f"native reader: format {fmt_value} is not bound in dmlc_tpu_torch")


class Reader:
    """The native read -> chunk -> parse pipeline over a byte-range
    partition of local files (``reader.cc``), with the JAX package's
    signature. A C++ producer thread loads record-aligned chunks and parses
    them on ``nthread`` workers; :meth:`next` blocks (the interpreter lock
    released) until a parsed block is ready and wraps it with no copy."""

    def __init__(self, paths, sizes, part_index: int, num_parts: int,
                 fmt: int, num_col: int = 0, indexing_mode: int = 0,
                 delimiter: str = ",", nthread: int = 0,
                 chunk_bytes: int = 1 << 20, queue_depth: int = 4,
                 batch_rows: int = 0, label_col: int = -1,
                 weight_col: int = -1, out_bf16: bool = False,
                 row_bucket: int = 0, nnz_bucket: int = 0,
                 elide_unit: bool = False, csr_wire: bool = False,
                 pack_aux: bool = False):
        lib = _load()
        if lib is None:
            raise DMLCError("native core unavailable")
        self._lib = lib
        self._fmt = fmt
        self._num_col = num_col
        arr_p = (ctypes.c_char_p * len(paths))(*[os.fsencode(p) for p in paths])
        arr_s = (ctypes.c_int64 * len(sizes))(*sizes)
        self._h = lib.dmlc_reader_create(
            arr_p, arr_s, len(paths), part_index, num_parts, fmt, num_col,
            indexing_mode, delimiter.encode()[0] if delimiter else b","[0],
            nthread or default_nthread(), chunk_bytes, queue_depth,
            batch_rows, label_col, weight_col, 1 if out_bf16 else 0,
            row_bucket, nnz_bucket, 1 if elide_unit else 0,
            1 if csr_wire else 0, 1 if pack_aux else 0)
        if not self._h:
            raise DMLCError("native reader creation failed (out of memory or threads)")
        self._check_error()

    def _check_error(self) -> None:
        err = self._lib.dmlc_reader_error(self._h)
        if err:
            raise DMLCError(err.decode())

    def next(self):
        """The next parsed block as ``(fmt, wrapped)``, None at the end of
        the partition. The tag can turn from ``FMT_LIBSVM_DENSE`` to
        ``FMT_LIBSVM`` mid-stream, for good, when the dense scanner meets a
        qid row."""
        if self._h is None:
            return None
        fmt = ctypes.c_int32(self._fmt)
        ptr = self._lib.dmlc_reader_next(self._h, ctypes.byref(fmt))
        if not ptr:
            self._check_error()
            return None
        return _wrap_stream_result(self._lib, ptr, fmt.value, self._num_col)

    def before_first(self) -> None:
        if self._h is not None:
            self._lib.dmlc_reader_before_first(self._h)

    @property
    def bytes_read(self) -> int:
        return self._lib.dmlc_reader_bytes_read(self._h) if self._h is not None else 0

    def close(self) -> None:
        if self._h is not None:
            self._lib.dmlc_reader_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class Feeder:
    """The push mode of the native pipeline (the JAX package's class): the
    caller streams a partition's raw bytes in, from any filesystem, and
    pulls parsed blocks out; record-aligned chunking, the threaded parse
    and the batch repack run in C++ as in :class:`Reader`.

    Contract: one feed thread calls :meth:`push` repeatedly, then
    :meth:`finish`; ``push`` blocks (the interpreter lock released) while
    the byte queue is full. Before :meth:`before_first` or :meth:`close`,
    call :meth:`abort` and join the feed thread."""

    def __init__(self, fmt: int, num_col: int = 0, indexing_mode: int = 0,
                 delimiter: str = ",", nthread: int = 0,
                 chunk_bytes: int = 1 << 20, queue_depth: int = 4,
                 batch_rows: int = 0, label_col: int = -1,
                 weight_col: int = -1, out_bf16: bool = False,
                 row_bucket: int = 0, nnz_bucket: int = 0,
                 elide_unit: bool = False, csr_wire: bool = False,
                 pack_aux: bool = False):
        lib = _load()
        if lib is None:
            raise DMLCError("native core unavailable")
        self._lib = lib
        self._fmt = fmt
        self._num_col = num_col
        self._h = lib.dmlc_feeder_create(
            fmt, num_col, indexing_mode, delimiter.encode()[0] if delimiter else b","[0],
            nthread or default_nthread(), chunk_bytes, queue_depth,
            batch_rows, label_col, weight_col, 1 if out_bf16 else 0,
            row_bucket, nnz_bucket, 1 if elide_unit else 0,
            1 if csr_wire else 0, 1 if pack_aux else 0)
        if not self._h:
            raise DMLCError("native feeder creation failed")

    def push(self, data) -> bool:
        """Feed bytes; False when the pipeline stopped (an error or an abort)."""
        if self._h is None:
            return False
        return self._lib.dmlc_feeder_push(self._h, bytes(data), len(data)) == 0

    def finish(self) -> None:
        if self._h is not None:
            self._lib.dmlc_feeder_finish(self._h)

    def abort(self) -> None:
        if self._h is not None:
            self._lib.dmlc_feeder_abort(self._h)

    def fail(self, msg: str) -> None:
        """Record a feed-side failure and end the stream; the consumer's
        :meth:`next` raises once the queued results have drained."""
        if self._h is not None:
            self._lib.dmlc_feeder_fail(self._h, msg.encode()[:512])

    def next(self):
        """The next parsed block as ``(fmt, wrapped)``, as
        :meth:`Reader.next`; None at the end of the stream."""
        if self._h is None:
            return None
        fmt = ctypes.c_int32(self._fmt)
        ptr = self._lib.dmlc_feeder_next(self._h, ctypes.byref(fmt))
        if not ptr:
            err = self._lib.dmlc_feeder_error(self._h)
            if err:
                raise DMLCError(err.decode())
            return None
        return _wrap_stream_result(self._lib, ptr, fmt.value, self._num_col)

    def before_first(self) -> None:
        if self._h is not None:
            self._lib.dmlc_feeder_before_first(self._h)

    def error(self):
        """The pipeline's error, or None. An error survives
        :meth:`before_first` (the pipeline stays stopped): a clean restart
        after a failure needs a new Feeder."""
        if self._h is None:
            return None
        err = self._lib.dmlc_feeder_error(self._h)
        return err.decode() if err else None

    @property
    def bytes_read(self) -> int:
        return self._lib.dmlc_feeder_bytes_read(self._h) if self._h is not None else 0

    def close(self) -> None:
        if self._h is not None:
            self._lib.dmlc_feeder_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class IndexedReader:
    """The native indexed RecordIO pipeline (``reader.cc`` IndexedReader;
    indexed_recordio_split.cc:12-41, 159-233): record-count partitioning
    over an external index, batched contiguous reads, and with ``shuffle``
    a per-epoch permutation (mt19937_64 from ``seed``) read by seeks.
    :meth:`next` blocks (the interpreter lock released) until a batch of
    extracted payloads is ready and wraps it as ``(payload, offsets)``."""

    def __init__(self, paths, sizes, index_offsets, part_index: int, num_parts: int,
                 batch_records: int = 256, shuffle: bool = False, seed: int = 0,
                 queue_depth: int = 4):
        lib = _load()
        if lib is None:
            raise DMLCError("native core unavailable")
        self._lib = lib
        arr_p = (ctypes.c_char_p * len(paths))(*[os.fsencode(p) for p in paths])
        arr_s = (ctypes.c_int64 * len(sizes))(*sizes)
        arr_i = (ctypes.c_int64 * len(index_offsets))(*index_offsets)
        self._h = lib.dmlc_indexed_reader_create(
            arr_p, arr_s, len(paths), arr_i, len(index_offsets), part_index, num_parts,
            batch_records, 1 if shuffle else 0, seed, queue_depth)
        if not self._h:
            raise DMLCError("native indexed reader creation failed (out of memory)")
        self._check_error()

    def _check_error(self) -> None:
        err = self._lib.dmlc_indexed_reader_error(self._h)
        if err:
            raise DMLCError(err.decode())

    def next(self):
        """The next batch as ``(payload, offsets)``; None at the end."""
        if self._h is None:
            return None
        ptr = self._lib.dmlc_indexed_reader_next(self._h)
        if not ptr:
            self._check_error()
            return None
        return _wrap_records(self._lib, ctypes.cast(ptr, ctypes.POINTER(_RecordBatchResult)))

    def before_first(self) -> None:
        """The epoch reset; under shuffle the next epoch's permutation."""
        if self._h is not None:
            self._lib.dmlc_indexed_reader_before_first(self._h)

    def skip(self, epochs: int, records: int) -> None:
        """Land in epoch ``epochs`` at record ``records`` with no prefix
        read (the permutations are replayed from the seed). Forward only."""
        if self._h is not None:
            self._lib.dmlc_indexed_reader_skip(self._h, epochs, records)
            self._check_error()

    @property
    def bytes_read(self) -> int:
        return (self._lib.dmlc_indexed_reader_bytes_read(self._h)
                if self._h is not None else 0)

    def close(self) -> None:
        if self._h is not None:
            self._lib.dmlc_indexed_reader_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
