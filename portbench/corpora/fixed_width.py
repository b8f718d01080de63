"""What the format writers share: rows of one fixed width built with numpy
in bulk, the ids and labels drawn from the seed.

Ids, values and labels come from ``numpy.random.default_rng(seed)`` in
blocks of :data:`CHUNK` rows, so a corpus is a function of the seed and
the configuration alone. Ids are written zero-padded to the width of the
largest id, so that every row of a corpus has one width."""

from __future__ import annotations

import copy
import os

import numpy as np

CHUNK = 1 << 16
TINY_NUM_COL = 600  # the table of a configuration cut to CPU size


def tiny(config: dict, rows: int, batch: int) -> dict:
    """``config`` cut to CPU size: its widths kept (factors, fields,
    entries a row) and its table, corpus and batch cut down, each field's
    values in proportion, at least one each."""
    c = copy.deepcopy(config)
    total = sum(f["cardinality"] for f in c["fields"])
    off = len(c["dense"])
    for f in c["fields"]:
        f["cardinality"] = max(1, f["cardinality"] * TINY_NUM_COL // total)
        f["offset"] = off
        off += f["cardinality"]
    c.update(num_col=off, corpus_rows=rows, batch_size=batch)
    return c


def id_digits(num_col: int) -> int:
    return len(str(max(num_col - 1, 1)))


def _tokens(buf: np.ndarray, start: int, stride: int, count: int, width: int) -> np.ndarray:
    """A ``[n, count, width]`` view of ``buf [n, W]``: token ``j`` of each
    row is the ``width`` bytes at column ``start + j * stride``."""
    return np.lib.stride_tricks.as_strided(buf[:, start:], shape=(len(buf), count, width),
                                           strides=(buf.strides[0], stride, 1))


def put_digits(buf: np.ndarray, start: int, stride: int, values: np.ndarray,
               ndigits: int) -> None:
    """Write ``values [n, m]`` (non-negative integers below 10**ndigits) as
    ``ndigits`` zero-padded decimal digits, value ``j`` at column ``start +
    j * stride`` of every row of ``buf``."""
    n, m = values.shape
    view = _tokens(buf, start, stride, m, ndigits)
    v = values.astype(np.int64 if ndigits > 9 else np.int32)
    for d in range(ndigits - 1, -1, -1):
        v, digit = np.divmod(v, 10)
        view[:, :, d] = digit + ord("0")


def put_const(buf: np.ndarray, start: int, stride: int, count: int, text: str) -> None:
    """Write ``text`` at columns ``start + j * stride``, ``j < count``, of
    every row."""
    raw = np.frombuffer(text.encode(), dtype=np.uint8)
    _tokens(buf, start, stride, count, len(raw))[:] = raw


def draw_ids(rng: np.random.Generator, n: int, fields: list) -> np.ndarray:
    """``[n, len(fields)]`` column ids, uniform within each field: field
    ``f``'s ids lie in ``[offset, offset + cardinality)``."""
    card = np.array([f["cardinality"] for f in fields], dtype=np.int64)
    off = np.array([f["offset"] for f in fields], dtype=np.int64)
    rank = np.minimum((rng.random((n, len(fields))) * card).astype(np.int64), card - 1)
    return off + rank


def draw_dense(rng: np.random.Generator, n: int, dense: list) -> np.ndarray:
    """``[n, len(dense)]`` values ``log(1 + x)`` in micro-units (integers),
    the counts ``x`` log-uniform in ``[0, max_count]``."""
    if not dense:
        return np.zeros((n, 0), dtype=np.int64)
    top = np.array([d["max_count"] for d in dense], dtype=np.float64)
    x = np.floor(np.exp(rng.random((n, len(dense))) * np.log1p(top))) - 1.0
    x = np.clip(x, 0.0, top)
    return np.rint(np.log1p(x) * 1e6).astype(np.int64)


def labels(ids: np.ndarray, rule: dict) -> np.ndarray:
    """1 where the ids of ``rule["fields"]`` sum to a multiple of ``rule["mod"]``."""
    a, b = rule["fields"]
    return ((ids[:, a] + ids[:, b]) % rule["mod"] == 0).astype(np.uint8)


def write_rows(path: str, rows: int, width: int, fill, seed: int) -> dict:
    """Write ``rows`` lines of ``width`` bytes; ``fill(rng, buf)`` sets a
    ``[n, width]`` u8 block, its last column the newline."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        for start in range(0, rows, CHUNK):
            buf = np.empty((min(CHUNK, rows - start), width), np.uint8)
            fill(rng, buf)
            buf[:, -1] = ord("\n")
            f.write(buf.tobytes())
    return {"rows": rows, "bytes": rows * width}
