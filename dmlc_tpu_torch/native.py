"""ctypes binding of the C++ libsvm chunk parser, built on demand with g++.

The sources are the repository's ``native/src/*.cc`` (the same list and flags
the JAX package builds with), compiled by this port into its own
``dmlc_tpu_torch/_build/`` — never into ``native/build/``, which the JAX
package owns and rebuilds on its own schedule. Only ``dmlc_parse_libsvm``
is bound. Result arrays are wrapped as numpy views that own the malloc'd
buffers through a finalizer (zero copies on the handoff).

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
        lib.dmlc_parse_libsvm.restype = ctypes.POINTER(_CsrBlockResult)
        lib.dmlc_parse_libsvm.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int]
        # void* so the finalizer never depends on ctypes class identity
        lib.dmlc_free_block.argtypes = [ctypes.c_void_p]
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
    """Frees the C result when garbage collected."""

    __slots__ = ("__weakref__",)

    def __init__(self, lib, res):
        weakref.finalize(self, lib.dmlc_free_block,
                         ctypes.cast(res, ctypes.c_void_p).value)


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


def parse_libsvm(chunk: bytes, nthread: int = 0, indexing_mode: int = 0):
    """Parse a libsvm chunk natively; a dict of numpy arrays, or None when
    the native library is unavailable. Malformed input raises DMLCError."""
    lib = _load()
    if lib is None:
        return None
    res = lib.dmlc_parse_libsvm(chunk, len(chunk), nthread or default_nthread(),
                                indexing_mode)
    r = res.contents
    if r.error:
        msg = r.error.decode()
        lib.dmlc_free_block(res)
        raise DMLCError(msg)
    owner = _Owner(lib, res)
    n, nnz = r.n_rows, r.nnz
    out = {
        "offset": _view(r.offset, n + 1, np.int64, owner),
        "label": _view(r.label, n, np.float32, owner),
        "weight": _view(r.weight, n, np.float32, owner),
        "qid": _view(r.qid, n, np.int64, owner),
        "index": _view(r.index, nnz, np.uint64, owner),
        "value": _view(r.value, nnz, np.float32, owner),
        "_owner": owner,
    }
    if n == 0:
        out["offset"] = np.zeros(1, np.int64)
        out["label"] = np.empty(0, np.float32)
    if out["index"] is None:
        out["index"] = np.empty(0, np.uint64)
    return out
