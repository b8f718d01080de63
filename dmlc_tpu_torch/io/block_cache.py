"""The DMLC segment container: header, segments, crc'd footer, tail.

Own copy of the container machinery in the JAX package's
``io/block_cache.py``, trimmed to what the snapshot store
(:mod:`dmlc_tpu_torch.io.snapshot`) uses. The bytes on disk are the same,
so a container written by either package opens in the other::

    [header]   8-byte magic + u32 LE version + 4 zero pad bytes
    [segments] per record, its arrays: each start padded to 64-byte
               alignment, raw little-endian C-order bytes, one crc32
               rolling over padding + payload
    [footer]   utf-8 JSON (sort_keys, compact separators)
    [tail]     u64 footer_offset + u64 footer_len + u32 footer_crc LE
               + the magic again

bfloat16 without ``ml_dtypes``: a segment stored under the dtype string
``"bfloat16"`` reads on the host as ``uint16`` words (the same bytes), and
the device side views them as ``torch.bfloat16``. The writer takes a
``torch.bfloat16`` tensor and stores it under that name, as the JAX writer
stores an ``ml_dtypes`` array.

Publishing is local: the writer streams to ``<path>.<pid>.<seq>.tmp``, and
:func:`finish_container` fsyncs it and moves it into place with
``os.replace``, so a crash never leaves a torn file under ``path``. The
JAX package's tiered artifact store (budgets, pins, manifest) is not
ported.
"""

from __future__ import annotations

import itertools
import json
import mmap
import os
import struct
import zlib
from typing import Dict, List, Tuple

import numpy as np
import torch

from dmlc_tpu_torch.utils.check import DMLCError, check

CACHE_VERSION = 1  # the block-cache version source signatures carry
_TAIL_FMT = "<QQI"  # footer offset, footer length, footer crc32
_TAIL_LEN = struct.calcsize(_TAIL_FMT) + 8
_ALIGN = 64
_BF16 = "bfloat16"

# process-unique staging names: two writers of one path never share bytes
_stage_seq = itertools.count()


def stage_path(path: str) -> str:
    """A fresh staging name beside ``path``."""
    return f"{path}.{os.getpid()}.{next(_stage_seq)}.tmp"


def container_header(magic: bytes, version: int) -> bytes:
    """8-byte magic + u32 LE version + 4 zero pad bytes."""
    check(len(magic) == 8, "container magic must be 8 bytes")
    return magic + struct.pack("<I", version) + b"\0" * 4


def _pad_to(f, align: int) -> int:
    pos = f.tell()
    rem = pos % align
    if rem:
        f.write(b"\0" * (align - rem))
        pos += align - rem
    return pos


def _host_bytes(arr) -> Tuple[bytes, str]:
    """The canonical little-endian payload of ``arr`` and its stored dtype
    string: numpy's ``.str`` for numpy dtypes, ``"bfloat16"`` for a
    ``torch.bfloat16`` tensor."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().tobytes(), _BF16
        arr = t.numpy()
    arr = np.ascontiguousarray(arr)
    check(arr.dtype.kind != "V", f"unsupported segment dtype {arr.dtype}")
    return arr.tobytes(), arr.dtype.str


def write_segments(f, segments: Dict[str, object], names) -> tuple:
    """Serialize the present ``names`` arrays (numpy arrays or CPU tensors)
    at ``f``'s current position: canonical order, each start padded to 64
    bytes, one crc32 over padding and payload. Returns ``(end, crc,
    arrays)`` with ``arrays`` mapping name -> ``[dtype_str, abs_offset,
    nbytes]``."""
    arrays: Dict[str, list] = {}
    crc = 0
    for name in names:
        arr = segments.get(name)
        if arr is None:
            continue
        start = f.tell()
        rem = start % _ALIGN
        if rem:
            padding = b"\0" * (_ALIGN - rem)
            f.write(padding)
            crc = zlib.crc32(padding, crc)
            start += len(padding)
        raw, dtype_str = _host_bytes(arr)
        f.write(raw)
        crc = zlib.crc32(raw, crc)
        arrays[name] = [dtype_str, start, len(raw)]
    return f.tell(), crc & 0xFFFFFFFF, arrays


def _segment_dtype(dtype_str: str) -> np.dtype:
    """The host dtype a stored segment reads as; ``"bfloat16"`` reads as
    ``uint16`` words."""
    if dtype_str == _BF16:
        return np.dtype(np.uint16)
    return np.dtype(dtype_str)


def torch_dtype(dtype_str: str) -> torch.dtype:
    """The device dtype of a stored segment (``"bfloat16"`` included)."""
    if dtype_str == _BF16:
        return torch.bfloat16
    return torch.from_numpy(np.empty(0, np.dtype(dtype_str))).dtype


def read_segments(buf, arrays: Dict[str, list]) -> Dict[str, np.ndarray]:
    """{name: zero-copy numpy view over ``buf``} for a
    :func:`write_segments` ``arrays`` mapping."""
    out: Dict[str, np.ndarray] = {}
    for name, (dtype_str, off, nbytes) in arrays.items():
        dt = _segment_dtype(dtype_str)
        out[name] = np.frombuffer(buf, dtype=dt, count=nbytes // dt.itemsize,
                                  offset=int(off))
    return out


def span_layout(arrays: Dict[str, list], shapes=None, base: int = 0):
    """A record's ``arrays`` (+ optional ``shapes``) mapping as a hashable
    span layout ``((name, dtype_str, rel_offset, nbytes, shape), ...)``,
    offsets rebased to ``base`` — what
    :func:`dmlc_tpu_torch.ops.device_decode.decode_span` slices a
    verbatim-copied u8 span by."""
    entries = []
    for name, (dtype_str, off, nbytes) in arrays.items():
        shape = (shapes or {}).get(name)
        dt = _segment_dtype(dtype_str)
        shape = (tuple(int(d) for d in shape) if shape is not None
                 else (int(nbytes) // dt.itemsize,))
        entries.append((str(name), str(dtype_str), int(off) - int(base),
                        int(nbytes), shape))
    return tuple(entries)


def finish_container(f, tmp_path: str, path: str, footer: dict,
                     magic: bytes) -> None:
    """Write the crc'd JSON ``footer``, the tail record and the closing
    ``magic``, then fsync and move ``tmp_path`` into place at ``path``."""
    payload = json.dumps(footer, sort_keys=True, separators=(",", ":")).encode()
    off = _pad_to(f, _ALIGN)
    f.write(payload)
    f.write(struct.pack(_TAIL_FMT, off, len(payload), zlib.crc32(payload) & 0xFFFFFFFF))
    f.write(magic)
    f.flush()
    os.fsync(f.fileno())
    f.close()
    os.replace(tmp_path, path)


def open_container(path: str, magic: bytes, version: int, what: str):
    """mmap a published container and verify its structure (header magic
    and version, tail magic, footer crc). Returns ``(file, mmap,
    footer_dict)``; raises :class:`DMLCError`, with the file closed, on any
    structural problem."""
    header = container_header(magic, version)
    f = mm = None
    try:
        size = os.path.getsize(path)
        check(size >= len(header) + _TAIL_LEN, f"{what}: too short")
        f = open(path, "rb")
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    except (OSError, DMLCError) as exc:
        if mm is not None:
            mm.close()
        if f is not None:
            f.close()
        raise DMLCError(f"{what}: unreadable: {exc}") from exc
    try:
        head = mm[: len(header)]
        check(head[:8] == magic, f"{what}: bad magic")
        (ver,) = struct.unpack("<I", head[8:12])
        check(ver == version, f"{what}: version {ver} != {version}")
        tail = mm[size - _TAIL_LEN:]
        check(tail[-8:] == magic, f"{what}: truncated (no tail magic)")
        off, length, crc = struct.unpack(_TAIL_FMT, tail[: struct.calcsize(_TAIL_FMT)])
        check(off + length <= size - _TAIL_LEN, f"{what}: footer out of range")
        payload = mm[off: off + length]
        check(zlib.crc32(payload) & 0xFFFFFFFF == crc, f"{what}: footer crc mismatch")
        return f, mm, json.loads(payload)
    except Exception:
        mm.close()
        f.close()
        raise


def _normalize(obj):
    """JSON round-trip: the stored signature is what JSON preserves."""
    return json.loads(json.dumps(obj, sort_keys=True))


def source_signature(uri: str, part_index: int, num_parts: int, **config) -> dict:
    """The staleness key a container is bound to: the source files with
    sizes and mtimes, the partition, and the parser ``config``. Local
    paths only (the port reads no remote filesystem); the dict equals the
    JAX package's for the same corpus and settings."""
    base = uri.split("#", 1)[0].split("?", 1)[0]
    files: List[list] = []
    for part in base.split(";"):
        if not part:
            continue
        local = part[7:] if part.startswith("file://") else (
            part if "://" not in part else None)
        if local is None:
            files.append([part, None, None])
        elif os.path.isdir(local):
            for name in sorted(os.listdir(local)):
                fp = os.path.join(local, name)
                if os.path.isfile(fp):
                    st = os.stat(fp)
                    files.append([fp, st.st_size, st.st_mtime_ns])
        elif os.path.exists(local):
            st = os.stat(local)
            files.append([local, st.st_size, st.st_mtime_ns])
        else:
            files.append([part, None, None])
    return _normalize({
        "cache_version": CACHE_VERSION,
        "files": files,
        "partition": [int(part_index), int(num_parts)],
        "config": config,
    })


def remove_quietly(path: str) -> None:
    try:
        os.remove(path)
    except OSError:
        pass
