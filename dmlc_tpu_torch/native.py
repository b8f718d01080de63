"""ctypes binding of the C++ chunk parsers, built on demand with g++.

The sources are the repository's ``native/src/*.cc`` (the same list and flags
the JAX package builds with), compiled by this port into its own
``dmlc_tpu_torch/_build/`` — never into ``native/build/``, which the JAX
package owns and rebuilds on its own schedule. Four entry points are bound:
``dmlc_parse_libsvm`` and ``dmlc_parse_libfm`` (CSR blocks),
``dmlc_parse_libsvm_dense`` (libsvm straight to the dense layout; a qid
row raises :class:`NeedsCsrError`) and ``dmlc_parse_csv`` (a float32 cell
matrix). A chunk is bytes or a memoryview (an mmap slice), whose buffer
address is passed through with no copy. Result arrays are wrapped as numpy
views that own the malloc'd buffers through a finalizer (zero copies on the
handoff).

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
        for name in ("dmlc_free_block", "dmlc_free_dense", "dmlc_free_csv"):
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
    r = res.contents
    if r.error:
        msg = r.error.decode()
        needs_csr = bool(r.needs_csr)
        lib.dmlc_free_dense(res)
        raise NeedsCsrError(msg) if needs_csr else DMLCError(msg)
    owner = _Owner(lib.dmlc_free_dense, res)
    rows = r.n_rows
    if rows == 0:
        return np.zeros((0, num_col), np.float32), np.empty(0, np.float32), None, owner
    x = _view(r.x, rows * num_col, np.float32, owner)
    x = np.zeros((rows, num_col), np.float32) if x is None else x.reshape(rows, num_col)
    return (x, _view(r.label, rows, np.float32, owner),
            _view(r.weight, rows, np.float32, owner), owner)


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
