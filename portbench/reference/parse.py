"""The reference's own reading of a corpus: rows ``[r0, r1)`` of a libsvm
or libfm text file, by splitting lines on whitespace and tokens on ``:``,
nothing of the program's parser. Two forms, one for each layout the
program feeds:

- :func:`rows`, a padded batch ``(ids [n, K] int64, values [n, K] float32,
  label [n] float32, weight [n] float32)``: a row's entries in file order,
  then padding (the id ``num_col``, value 0);
- :func:`csr_rows`, ragged rows ``(offsets [n + 1] int64, ids [nnz]
  int64, values [nnz] float32, label [n] float32, weight [n] float32)``:
  row ``i``'s entries, in file order, at ``[offsets[i], offsets[i + 1])``;
  no K, nothing truncated, no padding.

A row past the end of the file has weight 0 and no entries (all padding
in the padded form): the program pads an epoch's last batch so."""

from __future__ import annotations

import numpy as np

SCAN = 1 << 26


def row_offset(f, row: int) -> int:
    """The byte offset at which line ``row`` starts (the file's size if it
    has fewer lines)."""
    f.seek(0)
    seen, base = 0, 0
    while row > 0:
        block = f.read(SCAN)
        if not block:
            return base
        nl = np.flatnonzero(np.frombuffer(block, dtype=np.uint8) == 10)
        if seen + len(nl) >= row:
            return base + int(nl[row - seen - 1]) + 1
        seen += len(nl)
        base += len(block)
    return 0


def _lines(path: str, r0: int, r1: int) -> list:
    with open(path, "rb") as f:
        f.seek(row_offset(f, r0))
        return [f.readline() for _ in range(r1 - r0)]


def _entries(tokens: list, fmt: str):
    """``(id, value)`` of each ``id:value`` (libfm: ``field:id:value``) token."""
    for tok in tokens:
        parts = tok.split(b":")
        if fmt == "libfm":
            parts = parts[1:]
        yield int(parts[0]), np.float32(float(parts[1]))


def rows(path: str, fmt: str, r0: int, r1: int, num_col: int, k: int):
    """Rows ``[r0, r1)`` as one padded batch (module docstring)."""
    n = r1 - r0
    ids = np.full((n, k), num_col, dtype=np.int64)
    vals = np.zeros((n, k), dtype=np.float32)
    label = np.zeros(n, dtype=np.float32)
    weight = np.zeros(n, dtype=np.float32)
    for i, line in enumerate(_lines(path, r0, r1)):
        tokens = line.split()
        if not tokens:
            continue
        label[i] = float(tokens[0])
        weight[i] = 1.0
        entries = tokens[1:]
        if len(entries) > k:
            raise ValueError(f"row {r0 + i} holds {len(entries)} entries, more than {k}")
        for j, (idx, val) in enumerate(_entries(entries, fmt)):
            ids[i, j] = idx
            vals[i, j] = val
    return ids, vals, label, weight


def csr_rows(path: str, fmt: str, r0: int, r1: int):
    """Rows ``[r0, r1)`` as ragged CSR arrays (module docstring), whatever
    their lengths."""
    n = r1 - r0
    offsets = np.zeros(n + 1, dtype=np.int64)
    label = np.zeros(n, dtype=np.float32)
    weight = np.zeros(n, dtype=np.float32)
    ids, vals = [], []
    for i, line in enumerate(_lines(path, r0, r1)):
        tokens = line.split()
        if tokens:
            label[i] = float(tokens[0])
            weight[i] = 1.0
            for idx, val in _entries(tokens[1:], fmt):
                ids.append(idx)
                vals.append(val)
        offsets[i + 1] = len(ids)
    return (offsets, np.array(ids, dtype=np.int64), np.array(vals, dtype=np.float32),
            label, weight)
