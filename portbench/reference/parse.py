"""The reference's own reading of a corpus: rows ``[r0, r1)`` of a libsvm
or libfm text file as a padded batch, by splitting lines on whitespace and
tokens on ``:``, nothing of the program's parser.

A batch is ``(ids [n, K] int64, values [n, K] float32, label [n] float32,
weight [n] float32)``; a row's entries in file order, then padding (the
id ``num_col``, value 0); a row past the end of the file is all padding
with weight 0 (the program pads an epoch's last batch so)."""

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


def rows(path: str, fmt: str, r0: int, r1: int, num_col: int, k: int):
    """Rows ``[r0, r1)`` as one padded batch (module docstring)."""
    n = r1 - r0
    ids = np.full((n, k), num_col, dtype=np.int64)
    vals = np.zeros((n, k), dtype=np.float32)
    label = np.zeros(n, dtype=np.float32)
    weight = np.zeros(n, dtype=np.float32)
    with open(path, "rb") as f:
        f.seek(row_offset(f, r0))
        lines = [f.readline() for _ in range(n)]
    for i, line in enumerate(lines):
        tokens = line.split()
        if not tokens:
            continue
        label[i] = float(tokens[0])
        weight[i] = 1.0
        entries = tokens[1:]
        if len(entries) > k:
            raise ValueError(f"row {r0 + i} holds {len(entries)} entries, more than {k}")
        for j, tok in enumerate(entries):
            parts = tok.split(b":")
            if fmt == "libfm":
                parts = parts[1:]
            ids[i, j] = int(parts[0])
            vals[i, j] = np.float32(float(parts[1]))
    return ids, vals, label, weight
