"""Binary stream serialization, endian-stable.

Own copy of the JAX package's ``utils/serializer.py``: the equivalent of
reference include/dmlc/serializer.h and io.h's typed
``Stream::Read<T>/Write<T>`` (io.h:38-105) for scalars, strings,
sequences, dicts and numpy arrays, always little-endian on the wire (the
reference's DMLC_IO_USE_LITTLE_ENDIAN=1 default, endian.h:39, byte-swapped
on big-endian hosts, serializer.h:83-104). The bytes are the JAX
package's, so a stream written by either package reads in the other.

Works on any file-like object with ``read``/``write`` (the streams of
:func:`dmlc_tpu_torch.io.stream.open_stream`, open files, BytesIO).
"""

from __future__ import annotations

import struct
from typing import Any, BinaryIO

import numpy as np

from dmlc_tpu_torch.utils.check import DMLCError

# wire format codes for fixed-width scalars
_FMT = {
    "int8": "<b", "uint8": "<B",
    "int32": "<i", "uint32": "<I",
    "int64": "<q", "uint64": "<Q",
    "float32": "<f", "float64": "<d",
    "bool": "<B",
}


def write_scalar(stream: BinaryIO, value, kind: str) -> None:
    stream.write(struct.pack(_FMT[kind], value))


def read_scalar(stream: BinaryIO, kind: str):
    fmt = _FMT[kind]
    size = struct.calcsize(fmt)
    data = _read_exact(stream, size)
    return struct.unpack(fmt, data)[0]


def _read_exact(stream: BinaryIO, size: int) -> bytes:
    data = stream.read(size)
    if len(data) != size:
        raise DMLCError(f"serializer: expected {size} bytes, got {len(data)} (truncated stream)")
    return data


def write_bytes(stream: BinaryIO, data: bytes) -> None:
    """length-prefixed bytes — string handler (serializer.h:160s uses u64 len)."""
    write_scalar(stream, len(data), "uint64")
    stream.write(data)


def read_bytes(stream: BinaryIO) -> bytes:
    n = read_scalar(stream, "uint64")
    return _read_exact(stream, n)


def write_str(stream: BinaryIO, s: str) -> None:
    write_bytes(stream, s.encode("utf-8"))


def read_str(stream: BinaryIO) -> str:
    return read_bytes(stream).decode("utf-8")


def write_ndarray(stream: BinaryIO, arr: np.ndarray) -> None:
    """dtype-tagged, shape-prefixed array; data always little-endian.

    The reference serializes std::vector<POD> as [u64 size][raw bytes]
    (serializer.h:128-158); we add dtype + ndim + shape so arrays round-trip
    without external schema.
    """
    arr = np.ascontiguousarray(arr)
    dt = arr.dtype.newbyteorder("<")
    write_str(stream, dt.str)
    write_scalar(stream, arr.ndim, "uint32")
    for dim in arr.shape:
        write_scalar(stream, dim, "uint64")
    stream.write(arr.astype(dt, copy=False).tobytes())


def read_ndarray(stream: BinaryIO) -> np.ndarray:
    dtype = np.dtype(read_str(stream))
    ndim = read_scalar(stream, "uint32")
    shape = tuple(read_scalar(stream, "uint64") for _ in range(ndim))
    count = 1
    for dim in shape:
        count *= dim
    data = _read_exact(stream, count * dtype.itemsize)
    return np.frombuffer(data, dtype=dtype).reshape(shape).copy()


# -- generic composite serializer (serializer.h STL handlers) --

_TAG_NONE, _TAG_BOOL, _TAG_INT, _TAG_FLOAT, _TAG_STR, _TAG_BYTES, _TAG_LIST, _TAG_DICT, _TAG_NDARRAY = range(9)


def write_obj(stream: BinaryIO, obj: Any) -> None:
    """Recursive tagged serialization of python composites + numpy arrays."""
    if obj is None:
        write_scalar(stream, _TAG_NONE, "uint8")
    elif isinstance(obj, bool):
        write_scalar(stream, _TAG_BOOL, "uint8")
        write_scalar(stream, int(obj), "uint8")
    elif isinstance(obj, int):
        if not (-(1 << 63) <= obj < (1 << 63)):
            raise DMLCError(f"serializer: int {obj} out of int64 range")
        write_scalar(stream, _TAG_INT, "uint8")
        write_scalar(stream, obj, "int64")
    elif isinstance(obj, float):
        write_scalar(stream, _TAG_FLOAT, "uint8")
        write_scalar(stream, obj, "float64")
    elif isinstance(obj, str):
        write_scalar(stream, _TAG_STR, "uint8")
        write_str(stream, obj)
    elif isinstance(obj, (bytes, bytearray)):
        write_scalar(stream, _TAG_BYTES, "uint8")
        write_bytes(stream, bytes(obj))
    elif isinstance(obj, (list, tuple)):
        write_scalar(stream, _TAG_LIST, "uint8")
        write_scalar(stream, len(obj), "uint64")
        for item in obj:
            write_obj(stream, item)
    elif isinstance(obj, dict):
        write_scalar(stream, _TAG_DICT, "uint8")
        write_scalar(stream, len(obj), "uint64")
        for key, value in obj.items():
            if not isinstance(key, str):
                raise DMLCError("serializer: dict keys must be str")
            write_str(stream, key)
            write_obj(stream, value)
    elif isinstance(obj, np.ndarray):
        write_scalar(stream, _TAG_NDARRAY, "uint8")
        write_ndarray(stream, obj)
    elif isinstance(obj, np.generic):
        write_obj(stream, obj.item())
    else:
        raise DMLCError(f"serializer: unsupported type {type(obj).__name__}")


def read_obj(stream: BinaryIO) -> Any:
    tag = read_scalar(stream, "uint8")
    if tag == _TAG_NONE:
        return None
    if tag == _TAG_BOOL:
        return bool(read_scalar(stream, "uint8"))
    if tag == _TAG_INT:
        return read_scalar(stream, "int64")
    if tag == _TAG_FLOAT:
        return read_scalar(stream, "float64")
    if tag == _TAG_STR:
        return read_str(stream)
    if tag == _TAG_BYTES:
        return read_bytes(stream)
    if tag == _TAG_LIST:
        n = read_scalar(stream, "uint64")
        return [read_obj(stream) for _ in range(n)]
    if tag == _TAG_DICT:
        n = read_scalar(stream, "uint64")
        return {read_str(stream): read_obj(stream) for _ in range(n)}
    if tag == _TAG_NDARRAY:
        return read_ndarray(stream)
    raise DMLCError(f"serializer: bad tag {tag}")


class Serializable:
    """Interface analog of dmlc::Serializable (io.h:132-146)."""

    def save(self, stream: BinaryIO) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def load(self, stream: BinaryIO) -> None:  # pragma: no cover - interface
        raise NotImplementedError
